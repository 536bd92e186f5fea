import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qadc_tpu.ops.tables import adc_tables
from qadc_tpu.ops.knn import exact_knn, assign_nearest
from qadc_tpu.ops.kmeans import kmeans
from qadc_tpu.ops.quantization import keep_prefix_bound, quantize_tables_int8
from qadc_tpu.ops.topk import merge_topk, topk_smallest, window_min_reduce


def test_adc_tables_oracle(rng):
    m, k, dsq, q = 8, 16, 4, 5
    centroids = rng.normal(size=(m, k, dsq)).astype(np.float32)
    residuals = rng.normal(size=(q, m * dsq)).astype(np.float32)
    tables = np.asarray(adc_tables(residuals, centroids))
    assert tables.shape == (q, m, k)
    for qi in range(q):
        sub = residuals[qi].reshape(m, dsq)
        for mi in range(m):
            for ki in range(k):
                want = np.sum((sub[mi] - centroids[mi, ki]) ** 2)
                # The ||a||^2+||b||^2-2ab form loses a few bits to cancellation.
                np.testing.assert_allclose(tables[qi, mi, ki], want, rtol=3e-3, atol=1e-3)


def test_exact_knn_oracle(rng):
    qv = rng.normal(size=(7, 12)).astype(np.float32)
    base = rng.normal(size=(50, 12)).astype(np.float32)
    dists, idx = exact_knn(qv, base, 5)
    dists, idx = np.asarray(dists), np.asarray(idx)
    full = ((qv[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    want_idx = np.argsort(full, axis=1)[:, :5]
    np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(want_idx, axis=1))
    np.testing.assert_allclose(dists, np.sort(full, axis=1)[:, :5], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(assign_nearest(qv, base)), np.argmin(full, axis=1)
    )


def test_kmeans_separated_clusters(rng):
    centers = np.array([[10.0, 0.0], [-10.0, 0.0], [0.0, 10.0]], np.float32)
    x = np.concatenate(
        [c + 0.1 * rng.normal(size=(50, 2)).astype(np.float32) for c in centers]
    )
    cents, assign = kmeans(jax.random.PRNGKey(0), x, 3, iters=10)
    cents = np.asarray(cents)
    # Each true center recovered to within noise.
    for c in centers:
        assert np.min(np.linalg.norm(cents - c, axis=1)) < 0.5
    # Assignment is consistent: 50 per cluster.
    counts = np.bincount(np.asarray(assign), minlength=3)
    np.testing.assert_array_equal(np.sort(counts), [50, 50, 50])


def _quantize_ref(val, qmin, qmax):
    """Direct port of QuantizerMAX<int8> (db_query_4.cpp:38-71) for oracle use."""
    delta = (qmax - qmin) / 127.0
    if val >= qmax:
        return 127
    return int((val - qmin) / delta)


def test_quantize_tables_matches_reference(rng):
    tables = rng.uniform(-1.0, 50.0, size=(4, 16)).astype(np.float32)
    qmax = 30.0
    clamped = np.maximum(tables, 0.0)
    qmin = float(clamped.min())
    got = np.asarray(quantize_tables_int8(tables, qmax))
    for i in range(4):
        for j in range(16):
            want = _quantize_ref(max(tables[i, j], 0.0), qmin, qmax)
            assert got[i, j] == want, (i, j, tables[i, j])
    assert got.dtype == np.int8
    assert got.min() >= 0 and got.max() <= 127


def test_keep_prefix_bound_matches_heap(rng):
    """Bound == max of a capacity-R heap seeded with one +inf."""
    import heapq

    d = rng.uniform(0, 100, size=(40,)).astype(np.float32)
    r = 10
    # Simulate reference kv_binheap: keep R smallest of {+inf} ∪ d.
    union = np.concatenate([[np.inf], d])
    want = np.sort(union)[r - 1]
    got = float(keep_prefix_bound(d[None, :], r)[0])
    assert got == pytest.approx(want)
    # Fewer than r values -> +inf.
    got2 = float(keep_prefix_bound(d[None, :3], r)[0])
    assert np.isinf(got2)
    # Mask support.
    mask = np.zeros(40, bool)
    mask[:r] = True
    want3 = np.sort(d[:r])[r - 1]
    got3 = float(keep_prefix_bound(d[None, :], r, mask[None, :])[0])
    assert got3 == pytest.approx(want3)


def test_window_min_reduce(rng):
    d = rng.uniform(size=(32, 3)).astype(np.float32)
    vals, idx = window_min_reduce(jnp.asarray(d), 8, base_index=100)
    vals, idx = np.asarray(vals), np.asarray(idx)
    for g in range(4):
        w = d[g * 8 : (g + 1) * 8]
        np.testing.assert_allclose(vals[g], w.min(0))
        np.testing.assert_array_equal(idx[g], w.argmin(0) + g * 8 + 100)


def test_topk_merge(rng):
    d = rng.uniform(size=(2, 20)).astype(np.float32)
    labels = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    v1, l1 = topk_smallest(jnp.asarray(d[:, :10]), jnp.asarray(labels[:, :10]), 4)
    v2, l2 = topk_smallest(jnp.asarray(d[:, 10:]), jnp.asarray(labels[:, 10:]), 4)
    v, l = merge_topk(v1, l1, v2, l2, 4)
    want = np.sort(d, axis=1)[:, :4]
    np.testing.assert_allclose(np.asarray(v), want, rtol=1e-6)
    want_l = np.argsort(d, axis=1)[:, :4]
    np.testing.assert_array_equal(np.sort(np.asarray(l), 1), np.sort(want_l, 1))


def test_topk_smallest_sort_path_matches_topk():
    """Tiny rows go through a stable sort instead of the TopK custom call;
    results (including tie order: lower index first) must be identical."""
    import jax
    import jax.numpy as jnp

    from qadc_tpu.ops.topk import topk_smallest

    rng = np.random.default_rng(9)
    for c in (7, 200, 1024):
        d = jnp.asarray(rng.integers(0, 50, size=(5, c)).astype(np.float32))
        lab = jnp.asarray(rng.integers(0, 10_000, size=(5, c)).astype(np.int32))
        k = min(100, c)
        sv, sl = topk_smallest(d, lab, k)  # sort path (c <= 1024)
        top, idx = jax.lax.top_k(-d, k)    # custom-call semantics
        np.testing.assert_array_equal(np.asarray(sv), np.asarray(-top))
        np.testing.assert_array_equal(
            np.asarray(sl), np.asarray(jnp.take_along_axis(lab, idx, axis=-1))
        )


def test_exact_screen_smallest_matches_topk():
    """The sort-cascade screen must be EXACT — identical values AND indices
    (tie order: lower index first) to lax.top_k at every width class: below
    the chunk size, one chunk level, several levels, non-dividing widths."""
    import jax
    import jax.numpy as jnp

    from qadc_tpu.ops.topk import exact_screen_smallest

    rng = np.random.default_rng(4)
    for q, c, k in [(3, 700, 100), (2, 1024, 200), (2, 5000, 100),
                    (1, 24576, 200), (2, 196608, 200), (4, 3000, 7)]:
        # integer-valued floats force heavy ties — the hard case for order
        d = jnp.asarray(rng.integers(0, 97, size=(q, c)).astype(np.float32))
        sv, si = exact_screen_smallest(d, k)
        top, ti = jax.lax.top_k(-d, k)
        np.testing.assert_array_equal(np.asarray(sv), np.asarray(-top))
        np.testing.assert_array_equal(np.asarray(si), np.asarray(ti))


def test_exact_tile_screen_exact_values_all_widths():
    """The tile screen must return EXACTLY the k smallest VALUES (tie ORDER
    may differ from lax.top_k across equal values — the set of values and
    any strictly-smaller element's index must match)."""
    import jax
    import jax.numpy as jnp

    from qadc_tpu.ops.topk import exact_tile_screen

    rng = np.random.default_rng(5)
    for q, c, k in [(3, 700, 100), (2, 13000, 200), (1, 98304, 200),
                    (2, 24576, 100), (4, 3000, 7), (1, 100000, 64)]:
        d = jnp.asarray(rng.normal(size=(q, c)).astype(np.float32))
        sv, si = exact_tile_screen(d, k)
        top, _ = jax.lax.top_k(-d, k)
        np.testing.assert_array_equal(np.asarray(sv), np.asarray(-top))
        # returned indices must point at the returned values
        np.testing.assert_array_equal(
            np.take_along_axis(np.asarray(d), np.asarray(si), axis=-1),
            np.asarray(sv),
        )


def test_exact_tile_screen_clustered_adversarial():
    """The failure mode the tile screen exists for: ALL true top-k packed
    into one contiguous span (one partition's worth of clustered neighbors).
    approx_min_k's segment reduction loses most of them; the tile screen
    must capture every one."""
    import jax.numpy as jnp

    from qadc_tpu.ops.topk import exact_tile_screen

    rng = np.random.default_rng(6)
    c, k = 98304, 100
    d = rng.uniform(10.0, 20.0, size=(1, c)).astype(np.float32)
    start = 40960
    d[0, start : start + k] = rng.uniform(0.0, 1.0, size=k).astype(np.float32)
    sv, si = exact_tile_screen(jnp.asarray(d), k)
    got = set(np.asarray(si)[0].tolist())
    assert got == set(range(start, start + k)), "clustered top-k not captured"
    np.testing.assert_allclose(
        np.sort(np.asarray(sv)[0]), np.sort(d[0, start : start + k]), rtol=0
    )


def test_exact_tile_screen_topk_variant_matches():
    """QADC_SCREEN_TOPK=1 (the lax.top_k A/B variant, kept as an
    instrument) must return the same exact values, with
    indices referencing the returned values."""
    import os

    import jax
    import jax.numpy as jnp

    from qadc_tpu.ops.topk import exact_tile_screen

    rng = np.random.default_rng(11)
    d = jnp.asarray(rng.normal(size=(2, 13000)).astype(np.float32))
    mins = jnp.min(
        jnp.pad(d, [(0, 0), (0, (-13000) % 32)], constant_values=jnp.inf)
        .reshape(2, -1, 32), axis=-1,
    )
    os.environ["QADC_SCREEN_TOPK"] = "1"
    jax.clear_caches()
    try:
        sv, si = exact_tile_screen(d, 100)
        sv2, si2 = exact_tile_screen(
            jnp.pad(d, [(0, 0), (0, (-13000) % 32)], constant_values=jnp.inf),
            100, mins=mins,
        )
    finally:
        os.environ["QADC_SCREEN_TOPK"] = "0"
        jax.clear_caches()
    top, _ = jax.lax.top_k(-d, 100)
    for v, i in ((sv, si), (sv2, si2)):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(-top))
        np.testing.assert_array_equal(
            np.take_along_axis(
                np.pad(np.asarray(d), [(0, 0), (0, (-13000) % 32)],
                       constant_values=np.inf),
                np.asarray(i), axis=-1),
            np.asarray(v),
        )


def test_exact_tile_screen_ties_and_infs():
    """Heavy ties (integer-valued) and +inf dead slots: values must still
    be the exact k smallest; indices must reference equal values."""
    import jax.numpy as jnp

    from qadc_tpu.ops.topk import exact_tile_screen

    rng = np.random.default_rng(7)
    d = rng.integers(0, 5, size=(2, 50000)).astype(np.float32)
    d[:, 25000:] = np.inf
    sv, si = exact_tile_screen(jnp.asarray(d), 150)
    import jax

    top, _ = jax.lax.top_k(-jnp.asarray(d), 150)
    np.testing.assert_array_equal(np.asarray(sv), np.asarray(-top))
    np.testing.assert_array_equal(
        np.take_along_axis(d, np.asarray(si), axis=-1), np.asarray(sv)
    )


def test_balance_centroids_bounds_max_cell(rng):
    """balance_centroids caps the largest cell at ~cap_ratio x mean with K
    fixed, and the result stays a valid local k-means (no empty cells
    created by the retire-smallest step)."""
    import jax

    from qadc_tpu.ops.kmeans import balance_centroids, kmeans

    # One dominant cluster (40% of mass) + spread: guarantees initial skew.
    k, n, dim = 16, 8000, 8
    centers = rng.normal(scale=4.0, size=(64, dim)).astype(np.float32)
    who = np.where(rng.random(n) < 0.4, 0, rng.integers(0, 64, n))
    x = centers[who] + rng.normal(size=(n, dim)).astype(np.float32) * 0.3
    cents, _ = kmeans(jax.random.PRNGKey(0), x, k, iters=10)
    from qadc_tpu.ops.knn import assign_nearest

    before = np.bincount(np.asarray(assign_nearest(x, cents)), minlength=k)
    cap_ratio = 2.0
    out, assign = balance_centroids(
        jax.random.PRNGKey(1), x, cents, cap_ratio=cap_ratio
    )
    after = np.bincount(np.asarray(assign), minlength=k)
    cap = int(cap_ratio * n / k)
    assert out.shape == cents.shape
    assert after.sum() == n
    assert after.max() <= cap, (before.max(), after.max(), cap)
    # assignments returned must match the returned centroids
    np.testing.assert_array_equal(
        np.asarray(assign), np.asarray(assign_nearest(x, out))
    )


def test_train_coarse_balance_cap_flag(rng):
    import jax

    from qadc_tpu.index import ivf
    from qadc_tpu.ops.knn import assign_nearest

    centers = rng.normal(scale=4.0, size=(8, 16)).astype(np.float32)
    who = np.where(rng.random(4000) < 0.5, 0, rng.integers(0, 8, 4000))
    x = centers[who] + rng.normal(size=(4000, 16)).astype(np.float32) * 0.2
    plain = ivf.train_coarse(jax.random.PRNGKey(3), x, 16, iters=8)
    balanced = ivf.train_coarse(jax.random.PRNGKey(3), x, 16, iters=8,
                                balance_cap=2.0)
    c0 = np.bincount(np.asarray(assign_nearest(x, plain)), minlength=16)
    c1 = np.bincount(np.asarray(assign_nearest(x, balanced)), minlength=16)
    assert c1.max() <= int(2.0 * 4000 / 16)
    assert c1.max() < c0.max()
