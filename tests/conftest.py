"""Test config: CPU with 8 virtual devices (multi-device tests run on a
simulated mesh, SURVEY.md §4).

jax.config takes effect before the lazily created backends, so this holds
whatever JAX_PLATFORMS says. Tests that need a GPU use the `gpu` fixture,
which decides at run time whether a card is present.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU answers nvidia-smi (decided at run time)."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU answered nvidia-smi -L")
    return out.stdout.strip()
