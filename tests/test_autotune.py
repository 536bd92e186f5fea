"""Geometry autotune: cache round trip + recorded picks applied by search."""

import json

import numpy as np
import jax
import pytest

from qadc_tpu import autotune
from qadc_tpu.index import ivf
from qadc_tpu.ops.knn import assign_nearest
from qadc_tpu.quantizers.pq import train_pq


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    dim, n = 32, 20000
    base = rng.normal(scale=2.0, size=(n, dim)).astype(np.float32)
    queries = base[:8] + 0.01
    coarse = ivf.train_coarse(jax.random.PRNGKey(0), base[:5000], 8, iters=6)
    a = np.asarray(assign_nearest(base[:5000], coarse))
    pq = train_pq(
        jax.random.PRNGKey(1), base[:5000] - np.asarray(coarse)[a], 16, 4, iters=6
    )
    return ivf.add(ivf.IVFIndex.create(pq, coarse), base), queries


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QADC_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_mem", {})
    monkeypatch.setattr(autotune, "_disk_loaded", False)


def test_bundled_defaults_load_under_user_cache():
    """The package ships a bundled picks file (autotune_defaults.json, empty
    until picks are measured on the supported device); it loads after the
    user cache, so user entries win, and keys name the device kind."""
    with open(autotune._bundled_defaults_path()) as f:
        bundled = json.load(f)
    assert isinstance(bundled, dict)
    key = "NVIDIA H100 80GB HBM3|ivf_qadc_grouped|m16x4|d128|pp4096|parts256|b32"
    assert autotune.lookup(key) == bundled.get(key, {})
    # User cache wins over any bundled entry.
    autotune.record(key, {"block_n": 1024, "grouped_window": 16})
    autotune._mem.clear()
    autotune._disk_loaded = False
    assert autotune.lookup(key) == {"block_n": 1024, "grouped_window": 16}


def test_batch_bucket():
    assert autotune.batch_bucket(1) == 1
    assert autotune.batch_bucket(5) == 8
    assert autotune.batch_bucket(128) == 128
    assert autotune.batch_bucket(512) == 512
    # 512 and 2048 are separate buckets: a large-batch pick can differ
    # (governor chunking) — one pick must not cover both.
    assert autotune.batch_bucket(1000) == 2048
    assert autotune.batch_bucket(4096) == 2048


def test_record_lookup_roundtrip_and_disk_persistence(built, tmp_path):
    index, queries = built
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    assert autotune.lookup(key) == {}
    autotune.record(key, {"block_n": 512, "grouped_window": 8})
    assert autotune.lookup(key) == {"block_n": 512, "grouped_window": 8}
    # A fresh process (cleared memory) reads the same pick from disk.
    autotune._mem.clear()
    autotune._disk_loaded = False
    assert autotune.lookup(key) == {"block_n": 512, "grouped_window": 8}
    with open(tmp_path / "autotune.json") as f:
        assert key in json.load(f)


def test_recorded_pick_is_applied_and_correct(built):
    """search_qadc with no explicit block args must read the recorded pick —
    and the picked geometry must return the same results as the default."""
    index, queries = built
    d0, l0 = ivf.search_qadc(
        index, queries, r=20, ma=4, keep=0.05, grouped=True, interpret=True, direct=False
    )
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    autotune.record(key, {"block_n": 512, "grouped_window": 8})
    seen = {}
    orig = autotune.lookup

    def spying_lookup(k):
        pick = orig(k)
        seen[k] = pick
        return pick

    autotune.lookup = spying_lookup
    try:
        d1, l1 = ivf.search_qadc(
            index, queries, r=20, ma=4, keep=0.05, grouped=True, interpret=True, direct=False
        )
    finally:
        autotune.lookup = orig
    assert seen.get(key) == {"block_n": 512, "grouped_window": 8}
    np.testing.assert_array_equal(np.asarray(l0)[:, 0], np.asarray(l1)[:, 0])


def test_explicit_args_bypass_tuning(built):
    """Caller-specified block_n/grouped_window never consult the cache."""
    index, queries = built
    called = []
    orig = autotune.lookup
    autotune.lookup = lambda k: called.append(k) or orig(k)
    try:
        ivf.search_qadc(
            index, queries, r=20, ma=4, keep=0.05, grouped=True, direct=False,
            interpret=True, block_n=512, grouped_window=8,
        )
    finally:
        autotune.lookup = orig
    assert called == []


def test_tune_records_a_pick_interpret(built):
    """tune_ivf_qadc (interpret mode on CPU) must measure candidates, pick a
    winner, and record it under the geometry key."""
    index, queries = built
    pick = autotune.tune_ivf_qadc(
        index, queries, r=20, ma=4, keep=0.05, interpret=True,
        block_candidates=(512, 1024), iters=2,
    )
    assert pick.get("block_n") in (512, 1024)
    assert pick.get("grouped_window") >= 1
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    assert autotune.lookup(key) == pick
