"""Persistent compilation cache.

Compiling the search programs takes seconds each, so entry points keep
compiled programs on disk. Where JAX_COMPILATION_CACHE_DIR is set, JAX reads
it itself and this module sets nothing else; otherwise the cache lives at a
fixed path inside the checkout, so a later process finds it again.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory compiled programs are kept in."""
    return os.environ.get(ENV_VAR) or CHECKOUT_CACHE_DIR


def enable() -> str:
    """Turn the persistent cache on (before the first compile); returns its
    directory."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return cache_dir()
