"""Host-clock device timing.

JAX dispatch is asynchronous: a call returns once its work is enqueued, not
when the device has finished it. Every timing here therefore ends each call
with block_until_ready inside the timed region, after untimed warm-up calls
that compile the program.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import numpy as np


def call_seconds(fn: Callable, iters: int = 10, warmup: int = 1) -> np.ndarray:
    """Seconds of each of `iters` calls of fn(), each fenced by
    block_until_ready on its result."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    out = np.empty(iters)
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out[i] = time.perf_counter() - t0
    return out


def median_seconds(fn: Callable, iters: int = 10, warmup: int = 1) -> float:
    """Median of call_seconds."""
    return float(np.median(call_seconds(fn, iters, warmup)))


def percentiles(fn: Callable, iters: int = 50, warmup: int = 1) -> dict:
    """p50/p90/p99 and mean seconds per call of fn()."""
    s = call_seconds(fn, iters, warmup)
    return {
        "p50": float(np.percentile(s, 50)),
        "p90": float(np.percentile(s, 90)),
        "p99": float(np.percentile(s, 99)),
        "mean": float(s.mean()),
    }
