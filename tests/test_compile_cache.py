"""Compile-cache path rule and host-clock timing helpers."""

import os

import jax
import numpy as np

from qadc_tpu import compile_cache
from qadc_tpu.eval import timing


def test_env_var_dir_is_used_and_nothing_else_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable() == str(tmp_path)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert calls == []


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    d = compile_cache.enable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir() == d            # same path every call
    assert calls == [("jax_compilation_cache_dir", d)]


def test_call_seconds_fences_each_call():
    seen = []

    def fn():
        seen.append(1)
        return jax.numpy.ones(3)

    s = timing.call_seconds(fn, iters=4, warmup=2)
    assert len(seen) == 6 and s.shape == (4,) and (s >= 0).all()
    p = timing.percentiles(fn, iters=5)
    assert set(p) == {"p50", "p90", "p99", "mean"}
    assert p["p50"] <= p["p99"]
    assert timing.median_seconds(fn, iters=3) >= 0
    assert np.isfinite(p["mean"])


def test_bench_peaks_are_keyed_by_device_kind():
    """bench.py divides only by published peaks of a known device; an
    unknown device is an error, never a default."""
    import sys

    import pytest

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    assert bench._peaks("NVIDIA H100 80GB HBM3") == {
        "hbm_gbps": 3350.0, "int8_tops": 1979.0}
    with pytest.raises(KeyError):
        bench._peaks("cpu")
