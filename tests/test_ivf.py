import numpy as np
import jax

from qadc_tpu.index import ivf
from qadc_tpu.ops.knn import exact_knn
from qadc_tpu.quantizers.pq import train_pq
from qadc_tpu.eval.recall import recall_at_r


def _build_ivf(rng, n=4000, dim=32, parts=16, sq_bits=4, sq_count=16):
    centers = rng.normal(scale=3.0, size=(12, dim)).astype(np.float32)
    which = rng.integers(0, 12, size=n)
    base = (centers[which] + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 12, size=40)] + rng.normal(size=(40, dim))).astype(
        np.float32
    )
    _, gt = exact_knn(queries, base, 1)

    key = jax.random.PRNGKey(0)
    coarse = ivf.train_coarse(key, base, parts, iters=15)
    # Train PQ on residuals (reference pipeline: indexdb_create1 residuals file).
    from qadc_tpu.ops.knn import assign_nearest

    a = assign_nearest(base, coarse)
    residuals = base - np.asarray(coarse)[np.asarray(a)]
    pq = train_pq(jax.random.PRNGKey(1), residuals, sq_count, sq_bits, iters=15)

    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    return index, base, queries, np.asarray(gt)


def test_ivf_build_invariants(rng):
    index, base, _, _ = _build_ivf(rng)
    assert index.n == 4000
    sizes = np.asarray(index.part_sizes)
    assert sizes.sum() == 4000
    # Residual check (reference: indexdb_create1 check_residuals to 1e-5).
    labels = np.asarray(index.labels)
    coarse = np.asarray(index.coarse_centroids)
    from qadc_tpu.ops.knn import assign_nearest

    a = np.asarray(assign_nearest(base, index.coarse_centroids))
    for pi in range(index.part_count):
        for row in range(int(sizes[pi])):
            assert a[labels[pi, row]] == pi  # stored in its assigned partition
    # All labels accounted for exactly once.
    real = np.concatenate(
        [labels[pi, : sizes[pi]] for pi in range(index.part_count)]
    )
    assert sorted(real.tolist()) == list(range(4000))


def test_ivf_adc_recall(rng):
    index, _, queries, gt = _build_ivf(rng, sq_bits=8, sq_count=8)
    _, labels = ivf.search_adc(index, queries, r=100, ma=8)
    rec = recall_at_r(np.asarray(labels), gt)
    assert rec > 0.9, rec


def test_ivf_qadc_recall(rng):
    index, _, queries, gt = _build_ivf(rng, sq_bits=4, sq_count=16)
    _, labels_f = ivf.search_adc(index, queries, r=100, ma=8)
    rec_f = recall_at_r(np.asarray(labels_f), gt)
    # keep sized so the prefix across 8 probed partitions (~250 codes each)
    # exceeds r=100: 0.1*250*8 = 200.
    _, labels_q = ivf.search_qadc(index, queries, r=100, ma=8, keep=0.1)
    rec_q = recall_at_r(np.asarray(labels_q), gt)
    assert rec_f > 0.85, rec_f
    assert rec_q >= rec_f - 0.05, (rec_q, rec_f)


def test_ivf_more_probes_more_recall(rng):
    index, _, queries, gt = _build_ivf(rng, sq_bits=8, sq_count=8)
    recs = []
    for ma in (1, 4, 12):
        _, labels = ivf.search_adc(index, queries, r=100, ma=ma)
        recs.append(recall_at_r(np.asarray(labels), gt))
    assert recs[0] <= recs[1] + 0.03 and recs[1] <= recs[2] + 0.03
    assert recs[2] > 0.9


def test_keep_for_init():
    from qadc_tpu.index.ivf import keep_for_init

    # README example: SIFT1M IVF-256, ma=24, keep=0.213% corresponds to
    # init = keep*ma*N/K = 0.00213*24*1e6/256 ~ 200 codes exact-scanned.
    keep = keep_for_init(200, 256, 24, 1_000_000)
    assert abs(keep - 0.00213) < 1e-4
    import pytest

    with pytest.raises(ValueError):
        keep_for_init(0, 256, 24, 1_000_000)


def test_ivf_incremental_add_matches_bulk(rng):
    index1, base, _, _ = _build_ivf(rng)
    # Rebuild with two adds; same final contents per partition.
    from qadc_tpu.index.ivf import IVFIndex
    import jax

    coarse = index1.coarse_centroids
    pq = index1.pq
    i2 = ivf.add(ivf.add(ivf.IVFIndex.create(pq, coarse), base[:1500]), base[1500:])
    assert i2.n == index1.n
    np.testing.assert_array_equal(
        np.asarray(i2.part_sizes), np.asarray(index1.part_sizes)
    )
    s1, s2 = np.asarray(index1.part_sizes), np.asarray(i2.part_sizes)
    l1, l2 = np.asarray(index1.labels), np.asarray(i2.labels)
    cb = index1.pq.code_size
    c1 = np.asarray(index1.codes).reshape(index1.part_count, -1, cb)
    c2 = np.asarray(i2.codes).reshape(i2.part_count, -1, cb)
    for pi in range(index1.part_count):
        np.testing.assert_array_equal(l1[pi, : s1[pi]], l2[pi, : s2[pi]])
        np.testing.assert_array_equal(c1[pi, : s1[pi]], c2[pi, : s2[pi]])
        # padded tails clamp to the last real row
        if s2[pi] > 0:
            np.testing.assert_array_equal(
                c2[pi, s2[pi]:], np.broadcast_to(c2[pi, s2[pi]-1], c2[pi, s2[pi]:].shape)
            )


def test_ivf_direct_small_batch_path(rng):
    """Direct (b-small low-latency) path: exact float ADC over probed parts.

    The direct screen is exact, so direct results must EQUAL search_adc
    (same probed partitions, exact distances, exact selection), whether the
    route is asked for explicitly or taken as the GPU default
    (interpret=True).
    """
    index, _, queries, gt = _build_ivf(rng)
    d_ref, l_ref = ivf.search_adc(index, queries, r=50, ma=4)
    for interp in (False, True):
        d, l = ivf.search_qadc(index, queries, r=50, ma=4, direct=True,
                               interpret=interp)
        np.testing.assert_array_equal(np.asarray(l), np.asarray(l_ref))
        np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref),
                                   rtol=0, atol=1e-4)


def test_ivf_direct_short_results_inf(rng):
    """Probed volume smaller than r: tail padded with +inf (heap-not-full
    semantics, reference query_common.hpp:356-358), finite results first.

    Exercises the direct path's sentinel masking: padded slots must never
    surface as finite distances, and sentinels are restored to +inf.
    """
    index, _, queries, _ = _build_ivf(rng, n=150, parts=16)
    # ma=1, partitions hold ~10 codes each; r=50 exceeds any single partition.
    d, l = ivf.search_qadc(index, queries[:4], r=50, ma=1, direct=True)
    d = np.asarray(d)
    sizes = np.asarray(index.part_sizes)
    assert np.isinf(d).any(), "expected +inf tail for short results"
    for qi in range(4):
        fin = np.isfinite(d[qi])
        # finite block is a prefix (ascending sort puts inf last)
        assert fin[: fin.sum()].all()
        # number of finite results == probed partition's real size (<= r)
        assert fin.sum() <= max(sizes)
    # labels of finite results are valid ids
    lab = np.asarray(l)
    for qi in range(4):
        fin = np.isfinite(d[qi])
        assert ((lab[qi][fin] >= 0) & (lab[qi][fin] < index.n)).all()


def test_ivf_direct_labels_multiquery(rng):
    """Direct-path label reconstruction (select-accumulate over assignments +
    flat element gather) across a batch with distinct probe sets."""
    index, _, queries, _ = _build_ivf(rng)
    d_ref, l_ref = ivf.search_adc(index, queries[:6], r=30, ma=3)
    d, l = ivf.search_qadc(index, queries[:6], r=30, ma=3, direct=True)
    np.testing.assert_array_equal(np.asarray(l), np.asarray(l_ref))
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), atol=1e-4)


def test_ivf_direct_auto_gate(rng, monkeypatch):
    """direct=False must never route to the direct impl; interpret=True with
    small probed volume must (the GPU default route's selection arm)."""
    import qadc_tpu.index.ivf as ivf_mod

    index, _, queries, _ = _build_ivf(rng)
    calls = []
    orig = ivf_mod._search_qadc_direct_impl

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(ivf_mod, "_search_qadc_direct_impl", spy)
    ivf_mod.search_qadc(index, queries[:1], r=10, ma=2, direct=False)
    assert not calls
    ivf_mod.search_qadc(index, queries[:1], r=10, ma=2, interpret=True)
    assert calls  # small volume + interpret -> direct auto-selected


def test_ivf_direct_sq_count_8(rng):
    """Direct path with sq_count=8 (cb=4): pre-fix the narrow-table kernel
    silently returned all-zero distances; must match search_adc exactly."""
    import jax
    import jax.numpy as jnp
    from qadc_tpu.ops.knn import assign_nearest

    D, N = 64, 4000
    A = rng.normal(size=(32, D)).astype(np.float32)
    base = (rng.normal(size=(N, 32)).astype(np.float32) @ A).astype(np.float32)
    qs = (rng.normal(size=(2, 32)).astype(np.float32) @ A).astype(np.float32)
    coarse = ivf.train_coarse(jax.random.PRNGKey(1), base, part_count=16, iters=5)
    a = np.asarray(assign_nearest(base, coarse))
    pq = train_pq(
        jax.random.PRNGKey(0), base - np.asarray(coarse)[a], 8, 4, iters=4
    )
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    d0, l0 = ivf.search_adc(index, jnp.asarray(qs), r=10, ma=4)
    d1, l1 = ivf.search_qadc(
        index, jnp.asarray(qs), r=10, ma=4, direct=True, interpret=True
    )
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l0))


def test_ivf_ma_exceeds_part_count(rng):
    """ma > part_count clamps to probing every partition (the reference's
    assignment binheap degrades unpredictably there)."""
    index, _, queries, _ = _build_ivf(rng, n=300, parts=8)
    d_all, l_all = ivf.search_qadc(index, queries[:4], r=20, ma=8)
    d_big, l_big = ivf.search_qadc(index, queries[:4], r=20, ma=50)
    np.testing.assert_array_equal(np.asarray(l_big), np.asarray(l_all))
    a_all = ivf.search_adc(index, queries[:4], r=20, ma=8)
    a_big = ivf.search_adc(index, queries[:4], r=20, ma=50)
    np.testing.assert_array_equal(np.asarray(a_big[1]), np.asarray(a_all[1]))


def test_ivf_direct_m32_geometry(rng):
    """Direct path at GIST geometry (M=32, cb=16 -> two 128-lane table
    halves in the compact rows_adc kernel) must equal search_adc exactly —
    the M=32 configs exercise the 16-byte code layout."""
    dim, n, p = 64, 6000, 8
    centers = rng.normal(scale=3.0, size=(p, dim)).astype(np.float32)
    base = (centers[rng.integers(0, p, n)]
            + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, p, 6)]
               + rng.normal(size=(6, dim))).astype(np.float32)
    from qadc_tpu.ops.knn import assign_nearest

    coarse = ivf.train_coarse(jax.random.PRNGKey(0), base[:3000], p, iters=5)
    a = np.asarray(assign_nearest(base[:3000], coarse))
    pq = train_pq(jax.random.PRNGKey(1), base[:3000] - np.asarray(coarse)[a],
                  32, 4, iters=5)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    d_ref, l_ref = ivf.search_adc(index, queries, r=30, ma=3)
    d, l = ivf.search_qadc(index, queries, r=30, ma=3, direct=True,
                           interpret=True)
    np.testing.assert_array_equal(np.asarray(l), np.asarray(l_ref))
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref),
                               rtol=0, atol=1e-3)


def test_search_qadc_bound_override(rng):
    """bound= replaces the keep-prefix estimate without breaking ranking:
    a sane external bound (the exact r-th distance) must reproduce the
    default results, and even a crushingly tight bound keeps the true
    nearest neighbor at rank 1 (saturation caps competitors at 127, never
    the minimum; rerank restores exact values)."""
    import jax
    import jax.numpy as jnp

    from qadc_tpu.index import ivf
    from qadc_tpu.ops.knn import assign_nearest, exact_knn
    from qadc_tpu.quantizers.pq import train_pq

    dim, n, nq, r, ma = 32, 6000, 16, 20, 4
    centers = rng.normal(scale=2.0, size=(12, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 12, n)]
            + rng.normal(size=(n, dim)).astype(np.float32) * 0.5)
    queries = (centers[rng.integers(0, 12, nq)]
               + rng.normal(size=(nq, dim)).astype(np.float32) * 0.5)
    coarse = ivf.train_coarse(jax.random.PRNGKey(0), base, 8, iters=6)
    a0 = np.asarray(assign_nearest(base, coarse))
    pq = train_pq(jax.random.PRNGKey(1), base - np.asarray(coarse)[a0], 16, 4,
                  iters=6)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    gtd, _ = exact_knn(queries, base, r)
    gtd = np.asarray(gtd)

    kw = dict(r=r, ma=ma, keep=0.05, direct=False, interpret=True)
    d0, l0 = ivf.search_qadc(index, queries, **kw)
    d1, l1 = ivf.search_qadc(index, queries,
                             bound=jnp.asarray(gtd[:, r - 1] * 1.2), **kw)
    # A sane bound reproduces the default top-1 and nearly all of top-r.
    np.testing.assert_array_equal(np.asarray(l0)[:, 0], np.asarray(l1)[:, 0])
    overlap = np.mean([
        len(set(np.asarray(l0)[i].tolist())
            & set(np.asarray(l1)[i].tolist())) / r
        for i in range(nq)
    ])
    assert overlap > 0.9, overlap
    # Crushing bound: competitors saturate, the minimum never does.
    d2, l2 = ivf.search_qadc(index, queries,
                             bound=jnp.asarray(gtd[:, 0] * 1.01), **kw)
    assert (np.asarray(l2)[:, 0] == np.asarray(l0)[:, 0]).mean() > 0.9
