"""Partition-sharded IVF search over a device mesh.

The Deep100M-class configuration (SURVEY §6): partitions are sharded across
devices (each device owns P/D partitions' codes+labels), the coarse
quantizer and PQ are replicated (KiB-scale), and queries are replicated.
Per query batch:

  1. assignment runs replicated (centroids are tiny);
  2. each shard computes keep-prefix distances for the (query, assignment)
     pairs whose partition it OWNS; a psum assembles the global per-query
     bound (pairs partition disjointly across shards);
  3. tables quantize replicated; each shard routes its owned pairs
     (index/routing.py) and scans them with the grouped window scan;
  4. each shard emits its local top-r (dist, label) pairs; one all_gather +
     local k-select merges — compute and memory both scale with 1/D.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from qadc_tpu.dist.mesh import SHARD_AXIS, make_mesh
from qadc_tpu.index.ivf import (
    IVFIndex,
    assign_queries,
    grouped_window_minima,
    rows_adc,
    tile_tables_rows,
    window_rerank,
)
from qadc_tpu.index.route import choose
from qadc_tpu.index.routing import route_queries
from qadc_tpu.kernels.window_scan import DEFAULT_WINDOW, window_min_to_float
from qadc_tpu.ops.quantization import (
    clamp_bound_to_max_distance,
    keep_prefix_bound,
    quantize_tables_int8,
)
from qadc_tpu.ops.tables import adc_tables
from qadc_tpu.ops.topk import exact_tile_screen, topk_smallest


def shard_ivf_partitions(index: IVFIndex, mesh) -> IVFIndex:
    """Shard partitions (codes/labels/part_sizes) over the mesh; pad P to a
    device multiple with empty partitions. Coarse centroids + PQ replicated."""
    d = mesh.shape[SHARD_AXIS]
    p = index.part_count
    p_pad = -(-p // d) * d
    codes = np.asarray(index.codes)
    labels = np.asarray(index.labels)
    sizes = np.asarray(index.part_sizes)
    coarse = np.asarray(index.coarse_centroids)
    if p_pad != p:
        extra = p_pad - p
        codes = np.concatenate(
            [codes, np.zeros((extra, *codes.shape[1:]), codes.dtype)]
        )
        labels = np.concatenate(
            [labels, np.zeros((extra, labels.shape[1]), labels.dtype)]
        )
        sizes = np.concatenate([sizes, np.zeros((extra,), sizes.dtype)])
        # Padded coarse centroids far away so no query is assigned to them.
        far = np.full((extra, coarse.shape[1]), 1e30, np.float32)
        coarse = np.concatenate([coarse, far])
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    out = IVFIndex(
        pq=index.pq,
        coarse_centroids=jnp.asarray(coarse),  # replicated
        codes=jax.device_put(jnp.asarray(codes), NamedSharding(mesh, P(SHARD_AXIS, None, None))),
        labels=jax.device_put(jnp.asarray(labels), NamedSharding(mesh, P(SHARD_AXIS, None))),
        part_sizes=jax.device_put(jnp.asarray(sizes), shard),
        n=index.n,
        max_part_size=index.max_part_size,
    )
    return out


def load_sharded_index(path: str, mesh) -> IVFIndex:
    """Assemble a partition-sharded IVFIndex from a sharded checkpoint, with
    each PROCESS reading only the partition rows it will own — resharding on
    load when the checkpoint's shard count differs from the process count.

    Multi-process counterpart of shard_ivf_partitions (which device_puts a
    host-global array and so only works single-process). The checkpoint's k
    shard files define a contiguous global partition axis of k*parts_per_shard
    rows; that axis is re-padded to a device multiple with empty partitions
    and re-sliced contiguously over the p running processes (a checkpoint
    written for 8 hosts restarts on 2, and vice versa — SURVEY §5.3 elastic
    restart; the reference has only the offline split_vecs sharder,
    split_vecs.cpp). Global arrays are assembled via
    jax.make_array_from_process_local_data — no host ever materializes the
    whole index. Works unchanged with one process or shards == processes.
    """
    from qadc_tpu.io.checkpoint import load_index_rows

    procs = jax.process_count()
    d = mesh.shape[SHARD_AXIS]
    if d % procs != 0:
        raise ValueError(f"mesh axis ({d}) must be a multiple of process count ({procs})")
    # Each process's rows are contiguous in the global partition axis, so the
    # mesh's device order must be process-major for the local rows to land on
    # the process's own devices.
    axis_devs = list(mesh.devices.reshape(-1))
    pidx = [dev.process_index for dev in axis_devs]
    if pidx != sorted(pidx):
        raise ValueError("mesh device order must be process-major along the shard axis")

    import json as _json
    import os as _os

    with open(_os.path.join(path, "manifest.json")) as f:
        manifest = _json.load(f)
    stored = int(manifest["parts_per_shard"]) * int(manifest["num_shards"])
    p_pad = -(-stored // d) * d  # device multiple (hence process multiple)
    per_proc = p_pad // procs
    i = jax.process_index()
    local, _ = load_index_rows(path, i * per_proc, (i + 1) * per_proc)

    coarse = np.asarray(local.coarse_centroids)  # global, stored rows
    if p_pad != coarse.shape[0]:
        # Extra empty partitions: centroids far away so no query probes them
        # (same convention as shard_ivf_partitions / save_index_sharded).
        far = np.full((p_pad - coarse.shape[0], coarse.shape[1]), 1e30, np.float32)
        coarse = np.concatenate([coarse, far])

    def mk(arr, spec):
        arr = np.asarray(arr)
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), arr, (p_pad,) + arr.shape[1:]
        )

    out = IVFIndex(
        pq=local.pq,
        coarse_centroids=jnp.asarray(coarse),  # replicated
        codes=mk(local.codes, P(SHARD_AXIS, None, None)),
        labels=mk(local.labels, P(SHARD_AXIS, None)),
        part_sizes=mk(local.part_sizes, P(SHARD_AXIS)),
        n=local.n,
        max_part_size=local.max_part_size,
    )
    return out


@partial(
    jax.jit,
    static_argnames=(
        "r", "ma", "keep", "prefix_pad", "group_size", "window", "scan",
        "mesh", "overlap_chunks",
    ),
)
def _search_impl(
    index: IVFIndex, queries, r: int, ma: int, keep: float, prefix_pad: int,
    group_size: int, window: int, scan: str, mesh,
    overlap_chunks: int = 1,
):
    d = mesh.shape[SHARD_AXIS]
    p_total = index.part_count
    p_loc = p_total // d
    part_pad = index.part_pad
    m = index.pq.sq_count
    q = queries.shape[0]
    qa = q * ma
    cb = m // 2

    # Replicated front: assignment + residual tables.
    parts, rot = assign_queries(index, queries, ma)        # (Q, ma) global ids
    tables = adc_tables(rot, index.pq.centroids)           # (Q, ma, M, 16)
    tables_nn = jnp.maximum(tables, 0.0)
    max_possible = jnp.max(jnp.sum(jnp.max(tables_nn, axis=-1), axis=-1), axis=-1)
    qmin = jnp.min(tables_nn, axis=(-3, -2, -1))
    tflat = tables.reshape(qa, m * 16)

    def local_shard(codes_l, labels_l, sizes_l, parts_g, tflat_g, maxp, qmn):
        shard_i = jax.lax.axis_index(SHARD_AXIS)
        offset = shard_i * p_loc
        parts_local = parts_g - offset                      # (Q, ma)
        owned = (parts_local >= 0) & (parts_local < p_loc)
        parts_safe = jnp.where(owned, parts_local, 0)

        tables_g = tflat_g.reshape(q, ma, m, 16)
        sizes_pair = jnp.where(owned, sizes_l[parts_safe], 0)  # (Q, ma)

        # ---- keep-prefix distances for OWNED pairs; psum assembles globally.
        # Whole-ROW128-row gathers + full-lane select-accumulate (rows_adc);
        # table tiles shared with the rerank below — see index.ivf.
        starts_sizes = jnp.maximum(
            1, (sizes_pair.astype(jnp.float32) * keep).astype(jnp.int32)
        )
        starts_sizes = jnp.where(sizes_pair > 0, starts_sizes, 0)
        cpr = 128 // cb
        rows_per_part = part_pad // cpr
        ppr = -(-prefix_pad // cpr)
        tiles = tile_tables_rows(tables_g.reshape(qa, m, 16))
        tlo_full, thi_full = tiles
        prow = (
            parts_safe.reshape(qa)[:, None] * rows_per_part
            + jnp.arange(ppr, dtype=jnp.int32)[None, :]
        ).reshape(qa * ppr)
        rows = codes_l.reshape(-1, 128)[prow]               # (QA*ppr, 128)
        pair_of_row = (
            jnp.arange(qa, dtype=jnp.int32)[:, None]
            .repeat(ppr, axis=1).reshape(qa * ppr)
        )
        pd = rows_adc(rows, tlo_full[pair_of_row], thi_full[pair_of_row], cb)
        pd = pd.reshape(q, ma, ppr * cpr)
        col = jnp.arange(ppr * cpr, dtype=jnp.int32)
        valid = (col[None, None, :] < starts_sizes[:, :, None]) & owned[:, :, None]
        pd = jnp.where(valid, pd, 0.0)
        pd_global = jax.lax.psum(pd, SHARD_AXIS)            # disjoint -> sum
        valid_global = jax.lax.psum(valid.astype(jnp.int32), SHARD_AXIS) > 0
        bound = keep_prefix_bound(
            pd_global.reshape(q, ma * ppr * cpr), r,
            valid_global.reshape(q, ma * ppr * cpr),
        )
        bound = clamp_bound_to_max_distance(bound, maxp)

        qtables = quantize_tables_int8(
            tables_g, bound[:, None, None, None], qmn[:, None, None, None]
        )

        def scan_chunk(parts_c, sizes_c, qtables_c, tables_c, tiles_c):
            """Scan + rerank one query sub-chunk; returns local top-r."""
            qc = parts_c.shape[0]
            qac = qc * ma
            # ---- route owned pairs; unowned pairs route to partition 0 and
            # are masked below by their zeroed size.
            routed = route_queries(parts_c, p_loc, group_size)
            cv = window_min_to_float(grouped_window_minima(
                codes_l, sizes_l, routed, qtables_c.reshape(qac, m * 16),
                code_size=cb, part_pad=part_pad, window=window, scan=scan,
            ))                                              # (Qc*ma, C)
            c = part_pad // window
            wstart = jnp.arange(c, dtype=jnp.int32) * window
            cv = jnp.where(wstart[None, :] < sizes_c.reshape(qac)[:, None], cv, jnp.inf)

            # ---- query-level window merge + whole-window exact rerank
            # (local, shared 2-D-shaped helper — index.ivf.window_rerank).
            # The single-device grouped path reranks the query's top wq = r
            # windows over ALL its probes (containment note in
            # index.ivf._search_qadc_grouped_impl). Each shard screens its
            # own top wq by (minimum, window column), then keeps only those
            # at or before the GLOBAL wq-th (one small all_gather): every
            # window column belongs to one shard, so the shards together
            # rerank exactly the windows one device reranks.
            wq = min(r, ma * c)
            cv_q = cv.reshape(qc, ma * c)
            screen_v, selq = exact_tile_screen(cv_q, wq)
            all_v, all_i = jax.lax.sort(
                (jax.lax.all_gather(screen_v, SHARD_AXIS, axis=1, tiled=True),
                 jax.lax.all_gather(selq, SHARD_AXIS, axis=1, tiled=True)),
                dimension=1, num_keys=2,
            )
            cut_v, cut_i = all_v[:, wq - 1 : wq], all_i[:, wq - 1 : wq]
            keep = (screen_v < cut_v) | ((screen_v == cut_v) & (selq <= cut_i))
            screen_v = jnp.where(keep, screen_v, jnp.inf)
            sel_ai = selq // c
            sel_wi = selq % c
            sel_pair = jnp.arange(qc, dtype=jnp.int32)[:, None] * ma + sel_ai
            sel_part = jnp.take_along_axis(parts_c, sel_ai, axis=1)
            sel_sz = jnp.take_along_axis(sizes_c, sel_ai, axis=1)
            return window_rerank(
                codes_l.reshape(-1, 128), labels_l.reshape(-1), part_pad,
                tables_c, screen_v, sel_part, sel_pair, sel_wi, sel_sz,
                r, window, tiles=tiles_c,
            )

        # Unowned pairs are masked by zeroing their effective size: every
        # window then reads as empty (inf) and the pair contributes nothing.
        sizes_masked = jnp.where(owned, sizes_pair, 0)

        # SCAN <-> MERGE OVERLAP (SURVEY §5.8): process the query batch in
        # overlap_chunks sub-chunks; chunk i+1's scan has no data dependency
        # on chunk i's all_gather, so XLA's async collectives (NCCL over
        # NVLink) run while the next scan computes. The final top-r merge consumes all chunks.
        nchunks = overlap_chunks if q % overlap_chunks == 0 else 1
        qc = q // nchunks
        tlo_full, thi_full = tiles
        gathered_v, gathered_l = [], []
        for ci in range(nchunks):
            qs, qe = ci * qc, (ci + 1) * qc
            ps, pe = qs * ma, qe * ma
            lv, ll = scan_chunk(
                parts_safe[qs:qe], sizes_masked[qs:qe], qtables[qs:qe],
                tables_g[qs:qe], (tlo_full[ps:pe], thi_full[ps:pe]),
            )
            # (Qc, D*r) — issued now, consumed after the remaining chunks.
            gathered_v.append(
                jax.lax.all_gather(lv, SHARD_AXIS, axis=1, tiled=True)
            )
            gathered_l.append(
                jax.lax.all_gather(ll, SHARD_AXIS, axis=1, tiled=True)
            )
        all_v = (
            gathered_v[0] if nchunks == 1 else jnp.concatenate(gathered_v, axis=0)
        )
        all_l = (
            gathered_l[0] if nchunks == 1 else jnp.concatenate(gathered_l, axis=0)
        )
        return topk_smallest(all_v, all_l, r)

    shard_fn = jax.shard_map(
        local_shard,
        mesh=mesh,
        in_specs=(
            P(SHARD_AXIS, None, None),  # codes
            P(SHARD_AXIS, None),        # labels
            P(SHARD_AXIS),              # sizes
            P(), P(), P(), P(),         # parts, tflat, max_possible, qmin
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return shard_fn(
        index.codes, index.labels, index.part_sizes, parts, tflat,
        max_possible, qmin
    )


def search_qadc_ivf_sharded(
    index: IVFIndex, queries, r: int = 100, ma: int = 1, keep: float = 0.01,
    mesh=None, group_size: int = 128, window: int | None = None,
    interpret: bool = False, overlap_chunks: int = 1,
):
    """Quick-ADC search over a partition-sharded IVFIndex.

    Same semantics as index.ivf.search_qadc (grouped path, rerank on); work
    and memory scale with 1/n_devices.

    overlap_chunks > 1 software-pipelines the scan against the cross-shard
    top-k all_gather (SURVEY §5.8 scan<->merge overlap): the query batch is
    processed in that many sub-chunks, and chunk i+1's scan is independent of
    chunk i's all_gather, so XLA's async collectives overlap it with compute.
    Results are identical for any value (must divide the batch; falls back to
    1 otherwise). Default 1 = off; A/B on hardware before changing.
    """
    if index.pq.sq_bits != 4:
        raise ValueError("Quick ADC requires sq_bits == 4")
    # Probing more partitions than exist == probing all (see ivf.search_qadc).
    ma = min(ma, index.part_count)
    if mesh is None:
        mesh = make_mesh()
    if index.part_count % mesh.shape[SHARD_AXIS] != 0:
        raise ValueError("partition count must be a device multiple (use shard_ivf_partitions)")
    prefix_pad = max(1, int(index.max_part_size * keep)) if index.max_part_size else 1
    prefix_pad = min(prefix_pad, index.part_pad)
    if window is None:
        window = min(index.cpr, DEFAULT_WINDOW)
    scan = choose("ivf_qadc", index, grouped=True, direct=False,
                  interpret=interpret).scan
    return _search_impl(
        index, queries, r, ma, keep, prefix_pad, group_size, window, scan,
        mesh, overlap_chunks,
    )
