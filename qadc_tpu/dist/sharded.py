"""Sharded search over a device mesh.

New subsystem (the reference's only "sharding" is the offline split_vecs tool,
SURVEY.md §2.3/§5.8). Two modes:

1. CODE SHARDING (flat): codes split along N over the `shard` axis; queries
   and tables replicated. Each device screens its resident shard (and float-
   reranks its own candidates locally — candidate codes never cross devices),
   then per-shard top-k merges with one all_gather of (dist, label) pairs.
   This is the top-k analog of context-parallel attention: partial results +
   a combiner instead of softmax renormalization.

2. QUERY DATA-PARALLEL: the index is replicated; the query batch splits over
   devices; each device runs the full single-device search on its slice.
   QPS scales with devices — the serving mode for indexes that fit in one
   device's memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from qadc_tpu.core.packing import gather_codes_row128, row128_to_codes, unpack_codes
from qadc_tpu.dist.mesh import SHARD_AXIS, make_mesh
from qadc_tpu.index.flat import FlatIndex, _prefix_size, window_search
from qadc_tpu.index.route import choose
from qadc_tpu.kernels.window_scan import DEFAULT_WINDOW
from qadc_tpu.kernels.scan_ref import adc_scan_f32, adc_scan_int8
from qadc_tpu.ops.quantization import (
    clamp_bound_to_max_distance,
    keep_prefix_bound,
    quantize_tables_int8,
)
from qadc_tpu.ops.tables import adc_tables
from qadc_tpu.ops.topk import topk_smallest


def shard_flat_codes(index: FlatIndex, mesh) -> FlatIndex:
    """Re-pad codes so every shard gets equal rows; place sharded on the mesh.

    Codes are row128 storage; padding granularity is d*1024 codes.
    """
    d = mesh.shape[SHARD_AXIS]
    rows = np.asarray(index.codes)
    cpr = index.cpr
    n_pad = rows.shape[0] * cpr
    target = -(-n_pad // (d * 1024)) * (d * 1024)
    if target != n_pad:
        pad_rows = (target - n_pad) // cpr
        pad = np.broadcast_to(rows[-1], (pad_rows, 128))
        rows = np.concatenate([rows, pad], axis=0)
    sharded = jax.device_put(
        jnp.asarray(rows), NamedSharding(mesh, P(SHARD_AXIS, None))
    )
    return FlatIndex(pq=index.pq, codes=sharded, n=index.n)


@partial(
    jax.jit,
    static_argnames=("r", "keep", "rerank", "mesh", "use_kernel", "interpret"),
)
def search_qadc_flat_sharded(
    index: FlatIndex, queries, r: int = 100, keep: float = 0.01,
    rerank: bool = True, mesh=None, use_kernel: bool | None = None,
    interpret: bool = False,
):
    """Quick-ADC search over code-sharded FlatIndex.

    Same semantics as index.flat.search_qadc; the scan fans out over the mesh
    and candidates merge via all_gather.

    use_kernel: run the window scan + window-expansion path per shard
    (default: index.route decides — on the GPU when the local geometry
    allows); False = plain scan.
    interpret: take the window path with the scan kernel interpreted
    (CPU-mesh tests only; raises on an accelerator).
    """
    if mesh is None:
        mesh = make_mesh()
    if index.pq.sq_bits != 4:
        raise ValueError("Quick ADC requires sq_bits == 4")
    d = mesh.shape[SHARD_AXIS]
    cpr = index.cpr
    cb = index.pq.code_size
    n_pad = index.n_pad
    local_rows = n_pad // d

    rotated = index.pq.rotate(queries)
    tables = adc_tables(rotated, index.pq.centroids)        # (Q, M, 16) replicated
    q = tables.shape[0]
    m = index.pq.sq_count

    # Keep-prefix bound from the global prefix (computed replicated; prefix is
    # a slice of shard 0's rows — gathered automatically by XLA, it is tiny).
    ps = _prefix_size(index.n if index.n else n_pad, keep)
    prefix = row128_to_codes(index.codes[: -(-ps // cpr)], cb)[:ps]
    prefix_d = adc_scan_f32(prefix, tables, 4)
    bound = keep_prefix_bound(prefix_d, r)
    tables_nn = jnp.maximum(tables, 0.0)
    max_possible = jnp.sum(jnp.max(tables_nn, axis=-1), axis=-1)
    bound = clamp_bound_to_max_distance(bound, max_possible)
    qmin = jnp.min(tables_nn, axis=(-2, -1))
    qtables = quantize_tables_int8(tables, bound[:, None, None], qmin[:, None, None])

    rr = min((2 * r) if rerank else r, local_rows)
    tflat = tables.reshape(q, m * 16)
    n_real = index.n if index.n else 0
    window = min(cpr, DEFAULT_WINDOW)
    route = choose(
        "flat_sharded_qadc", index, q=local_rows, r=rr, grouped=use_kernel,
        interpret=interpret,
    )

    def local_shard(codes_local, qt, tf):
        shard_i = jax.lax.axis_index(SHARD_AXIS)
        offset = shard_i * local_rows
        glabels = jnp.minimum(
            offset + jnp.arange(local_rows, dtype=jnp.int32),
            max(n_real - 1, 0),
        )
        if route.path == "window":
            # Window scan of the resident shard + window expansion; labels
            # stay global, the rerank gathers only local rows.
            local_size = jnp.clip(n_real - offset, 0, local_rows)
            rank_t = tf.reshape(q, m, 16) if rerank else qt.astype(jnp.float32)
            cv, cl = window_search(
                codes_local, glabels, qt, rank_t, part=0,
                range_codes=local_rows, size=local_size, r=rr,
                wq=min(rr, local_rows // window), window=window,
                scan=route.scan,
            )
        else:
            packed_local = row128_to_codes(codes_local, cb)
            acc = adc_scan_int8(packed_local, qt, saturate=False)
            acc = acc.astype(jnp.float32)
            valid = offset + jnp.arange(local_rows, dtype=jnp.int32)
            acc = jnp.where(valid[None, :] < n_real, acc, jnp.inf)
            neg_top, rows = jax.lax.top_k(-acc, rr)
            cl = rows + offset
            if rerank:
                # Float rerank against LOCAL codes — candidate codes stay on-shard.
                cand_codes = gather_codes_row128(codes_local, rows, cb)  # (Q, rr, cb)
                idx = unpack_codes(cand_codes, m, 4)
                oh = jax.nn.one_hot(idx, 16, dtype=jnp.float32).reshape(q, rr, m * 16)
                cv = jnp.einsum("qcf,qf->qc", oh, tf, preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
                cv = jnp.where(jnp.isfinite(-neg_top), cv, jnp.inf)
            else:
                cv = -neg_top
        # Merge across shards: one all_gather of (dist, label) pairs.
        all_v = jax.lax.all_gather(cv, SHARD_AXIS, axis=1, tiled=True)   # (Q, D*rr)
        all_l = jax.lax.all_gather(cl, SHARD_AXIS, axis=1, tiled=True)
        return topk_smallest(all_v, all_l, r)

    shard_fn = jax.shard_map(
        local_shard,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS, None), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return shard_fn(index.codes, qtables, tflat)


def search_adc_flat_sharded(index: FlatIndex, queries, r: int = 100, mesh=None):
    """Float ADC search over code-sharded FlatIndex (any sq_bits)."""
    if mesh is None:
        mesh = make_mesh()
    return _search_adc_flat_sharded_impl(index, queries, r, mesh)


@partial(jax.jit, static_argnames=("r", "mesh"))
def _search_adc_flat_sharded_impl(index: FlatIndex, queries, r: int, mesh):
    d = mesh.shape[SHARD_AXIS]
    cb = index.pq.code_size
    n_pad = index.n_pad
    local_rows = n_pad // d
    rotated = index.pq.rotate(queries)
    tables = adc_tables(rotated, index.pq.centroids)
    n_real = index.n if index.n else 0
    sq_bits = index.pq.sq_bits
    rr = min(r, local_rows)

    def local_shard(codes_local, t):
        shard_i = jax.lax.axis_index(SHARD_AXIS)
        offset = shard_i * local_rows
        dists = adc_scan_f32(row128_to_codes(codes_local, cb), t, sq_bits)
        glabels = offset + jnp.arange(local_rows, dtype=jnp.int32)
        dists = jnp.where(glabels[None, :] < n_real, dists, jnp.inf)
        neg_top, rows = jax.lax.top_k(-dists, rr)
        all_v = jax.lax.all_gather(-neg_top, SHARD_AXIS, axis=1, tiled=True)
        all_l = jax.lax.all_gather(rows + offset, SHARD_AXIS, axis=1, tiled=True)
        return topk_smallest(all_v, all_l, r)

    shard_fn = jax.shard_map(
        local_shard,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS, None), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return shard_fn(index.codes, tables)


def search_query_parallel(search_fn, index, queries, mesh=None, **kwargs):
    """Run any single-chip search data-parallel over the query batch.

    Args:
      search_fn: e.g. index.flat.search_qadc or index.ivf.search_qadc —
        called as search_fn(index, local_queries, **kwargs) on each device.
      index: replicated index (FlatIndex or IVFIndex).
      queries: (Q, dim); Q padded to a device multiple internally.

    Returns:
      (dists (Q, r), labels (Q, r)) for the original Q rows.
    """
    if mesh is None:
        mesh = make_mesh()
    d = mesh.shape[SHARD_AXIS]
    queries = jnp.asarray(queries, jnp.float32)
    q = queries.shape[0]
    q_pad = -(-q // d) * d
    if q_pad != q:
        queries = jnp.pad(queries, ((0, q_pad - q), (0, 0)))

    index_specs = jax.tree.map(lambda _: P(), index)

    def local(idx, local_q):
        return search_fn(idx, local_q, **kwargs)

    shard_fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(index_specs, P(SHARD_AXIS, None)),
        out_specs=(P(SHARD_AXIS, None), P(SHARD_AXIS, None)),
        check_vma=False,
    )
    dists, labels = shard_fn(index, queries)
    return dists[:q], labels[:q]
