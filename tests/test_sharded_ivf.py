"""Partition-sharded IVF search on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import pytest

from qadc_tpu.dist.mesh import make_mesh
from qadc_tpu.dist.sharded_ivf import search_qadc_ivf_sharded, shard_ivf_partitions
from qadc_tpu.index import ivf
from qadc_tpu.quantizers.pq import train_pq
from qadc_tpu.ops.knn import exact_knn, assign_nearest
from qadc_tpu.eval.recall import recall_at_r


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(11)
    dim, n = 32, 24000
    centers = rng.normal(scale=3.0, size=(16, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 16, n)] + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 16, 16)] + rng.normal(size=(16, dim))).astype(np.float32)
    coarse = ivf.train_coarse(jax.random.PRNGKey(0), base[:5000], 24, iters=10)
    a = np.asarray(assign_nearest(base[:5000], coarse))
    pq = train_pq(jax.random.PRNGKey(1), base[:5000] - np.asarray(coarse)[a], 16, 4, iters=10)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    _, gt = exact_knn(queries, base, 1)
    return index, queries, np.asarray(gt)


def test_shard_pads_partitions(built):
    index, _, _ = built
    mesh = make_mesh()
    sharded = shard_ivf_partitions(index, mesh)
    assert sharded.part_count % 8 == 0
    assert sharded.n == index.n
    # Real partitions preserved.
    np.testing.assert_array_equal(
        np.asarray(sharded.part_sizes)[: index.part_count],
        np.asarray(index.part_sizes),
    )


def test_sharded_matches_single_device(built):
    index, queries, gt = built
    mesh = make_mesh()
    sharded = shard_ivf_partitions(index, mesh)
    d1, l1 = ivf.search_qadc(
        index, queries, r=50, ma=6, keep=0.05, grouped=True, interpret=True
    )
    d2, l2 = search_qadc_ivf_sharded(
        sharded, queries, r=50, ma=6, keep=0.05, mesh=mesh, interpret=True
    )
    d1, d2 = np.asarray(d1), np.asarray(d2)
    l1, l2 = np.asarray(l1), np.asarray(l2)
    rec1 = recall_at_r(l1, gt)
    rec2 = recall_at_r(l2, gt)
    assert rec2 >= rec1 - 0.07, (rec2, rec1)
    # Top-1 must agree (exact rerank on both sides).
    np.testing.assert_array_equal(l1[:, 0], l2[:, 0])
    np.testing.assert_allclose(d1[:, 0], d2[:, 0], rtol=1e-5)
    # Tail quality comparable.
    assert np.mean(d2[:, -1] - d1[:, -1]) < 2.0


def test_sharded_recall_vs_exact(built):
    index, queries, gt = built
    mesh = make_mesh()
    sharded = shard_ivf_partitions(index, mesh)
    _, labels = search_qadc_ivf_sharded(
        sharded, queries, r=100, ma=8, keep=0.05, mesh=mesh, interpret=True
    )
    rec = recall_at_r(np.asarray(labels), gt)
    assert rec > 0.85, rec


def test_sharded_ma_exceeds_part_count(rng):
    """ma > part_count through the sharded path clamps to probing all."""
    import jax.numpy as jnp
    from qadc_tpu.dist.mesh import make_mesh
    from qadc_tpu.dist.sharded_ivf import (
        search_qadc_ivf_sharded,
        shard_ivf_partitions,
    )
    from qadc_tpu.index import ivf
    from qadc_tpu.ops.knn import assign_nearest
    from qadc_tpu.quantizers.pq import train_pq

    base = rng.normal(size=(1500, 32)).astype(np.float32)
    coarse = ivf.train_coarse(jax.random.PRNGKey(1), base, part_count=8, iters=4)
    a = np.asarray(assign_nearest(base, coarse))
    pq = train_pq(jax.random.PRNGKey(2), base - np.asarray(coarse)[a], 16, 4, iters=4)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    mesh = make_mesh(8)
    sharded = shard_ivf_partitions(index, mesh)
    qs = jnp.asarray(base[:4] + 0.01)
    d_all, l_all = search_qadc_ivf_sharded(
        sharded, qs, r=10, ma=sharded.part_count, keep=0.05, mesh=mesh,
        interpret=True,
    )
    d_big, l_big = search_qadc_ivf_sharded(
        sharded, qs, r=10, ma=100, keep=0.05, mesh=mesh, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(l_big), np.asarray(l_all))


def test_sharded_overlap_chunks_identical(built):
    """Scan<->merge overlap (overlap_chunks > 1) must not change results —
    it only re-orders independent work so the all_gather rides under the
    next chunk's scan (SURVEY §5.8)."""
    index, queries, gt = built
    mesh = make_mesh()
    sharded = shard_ivf_partitions(index, mesh)
    kw = dict(r=50, ma=6, keep=0.05, mesh=mesh, interpret=True)
    d1, l1 = search_qadc_ivf_sharded(sharded, queries, **kw)
    d2, l2 = search_qadc_ivf_sharded(sharded, queries, overlap_chunks=2, **kw)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    # Non-dividing chunk counts fall back to 1 (still correct).
    d3, l3 = search_qadc_ivf_sharded(sharded, queries, overlap_chunks=5, **kw)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l3))


def test_sharded_tq_matches_row128(built):
    """Sharded scan kernel (interpreted) == sharded plain-XLA scan,
    bit-exact: the integer window minima are identical, so the whole tail
    is too (repadded index, part_pad a multiple of the kernel block)."""
    from qadc_tpu.index.build import repad_partitions

    index, queries, gt = built
    pad = -(-index.part_pad // 2048) * 2048
    ix = repad_partitions(index, pad)
    mesh = make_mesh()
    sharded = shard_ivf_partitions(ix, mesh)
    d1, l1 = search_qadc_ivf_sharded(
        sharded, queries, r=50, ma=6, keep=0.05, mesh=mesh, interpret=True
    )
    d0, l0 = search_qadc_ivf_sharded(
        sharded, queries, r=50, ma=6, keep=0.05, mesh=mesh, interpret=False
    )
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))
