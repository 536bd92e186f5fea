"""IVF (inverted file) index with multiple assignment.

Reference: index_db (databases.hpp:176-331) + scanner_4 (db_query_4.cpp:73-310).
part_count coarse centroids; each vector is stored in the partition of its
nearest centroid as a PQ code of its residual; a query probes its `ma` nearest
partitions with per-assignment residual tables.

Departures from the reference:
  - Partitions are a UNIFORM 3D array (P, part_pad, code_size) padded by
    repeating each partition's last code (labels clamp to the partition's last
    real label — reference tail quirk, simd_layout.hpp:47-50). Static shapes:
    probing = a gather along axis 0, no ragged pointers.
  - The reference's separate "starts" prefix buffers (db_query_4.cpp:133-191)
    are unnecessary: the keep-prefix of partition p is rows [0, size_p*keep) of
    the same 3D array, sliced statically and masked.
  - Coarse k-means training is in-framework and jitted (ops/kmeans.py).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qadc_tpu.core.layout import codes_per_row
from qadc_tpu.core.packing import gather_codes_row128, unpack_codes
from qadc_tpu.index import route as routes
from qadc_tpu.index.routing import group_capacity, route_queries
from qadc_tpu.kernels.window_scan import (
    DEFAULT_BLOCK_N,
    DEFAULT_WINDOW,
    window_min_scan,
    window_min_to_float,
)
from qadc_tpu.ops.kmeans import kmeans
from qadc_tpu.ops.knn import exact_knn
from qadc_tpu.ops.quantization import (
    clamp_bound_to_max_distance,
    keep_prefix_bound,
    quantize_tables_int8,
)
from qadc_tpu.ops.tables import adc_tables
from qadc_tpu.ops.topk import exact_tile_screen, merge_topk, topk_smallest
from qadc_tpu.quantizers.pq import ProductQuantizer

PART_ALIGN = 512  # partition padding granularity (codes); a multiple of the
                  # scan kernel's block so partitions tile evenly
MASK_BIG = 3.0e38  # finite "no candidate" distance of the direct path


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["pq", "coarse_centroids", "codes", "labels", "part_sizes"],
    meta_fields=["n", "max_part_size"],
)
@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """IVF index.

    Attributes:
      pq: ProductQuantizer / OPQQuantizer (trained on residuals).
      coarse_centroids: (P, dim) float32.
      codes: (P, part_pad/cpr, 128) uint8 ROW128 storage (core/layout.py).
      labels: (P, part_pad) int32.
      part_sizes: (P,) int32 real sizes.
      n: total real vector count — static.
      max_part_size: max real partition size — static (for keep slicing).
    """

    pq: ProductQuantizer
    coarse_centroids: jax.Array
    codes: jax.Array
    labels: jax.Array
    part_sizes: jax.Array
    n: int
    max_part_size: int

    @property
    def part_count(self) -> int:
        return self.coarse_centroids.shape[0]

    @property
    def cpr(self) -> int:
        return codes_per_row(self.pq.code_size)

    @property
    def part_pad(self) -> int:
        return self.codes.shape[1] * self.cpr

    @classmethod
    def create(cls, pq: ProductQuantizer, coarse_centroids) -> "IVFIndex":
        """Empty index (reference: indexdb_create1/2)."""
        cc = jnp.asarray(coarse_centroids, jnp.float32)
        p = cc.shape[0]
        cpr = codes_per_row(pq.code_size)
        return cls(
            pq=pq,
            coarse_centroids=cc,
            codes=jnp.zeros((p, PART_ALIGN // cpr, 128), jnp.uint8),
            labels=jnp.zeros((p, PART_ALIGN), jnp.int32),
            part_sizes=jnp.zeros((p,), jnp.int32),
            n=0,
            max_part_size=0,
        )


def set_quantizer(index: IVFIndex, pq: ProductQuantizer) -> IVFIndex:
    """Install an (externally trained) quantizer into an EMPTY IVF index.

    Reference: indexdb_create2 swaps the real residual-trained PQ/OPQ into
    the empty index emitted by indexdb_create1 (indexdb_create2.cpp:41-59) —
    the second step of its external-training workflow (README.md:166-260).
    Codes already present were encoded with the old quantizer and would be
    silently misinterpreted, so a non-empty index is rejected; swap first,
    then add vectors.
    """
    dim = index.coarse_centroids.shape[1]
    if pq.dim != dim:
        raise ValueError(f"quantizer dim {pq.dim} != index dim {dim}")
    if index.n != 0:
        raise ValueError(
            f"cannot swap quantizer into a non-empty index (n={index.n}): "
            "existing codes were encoded with the old quantizer"
        )
    return IVFIndex.create(pq, index.coarse_centroids)


def keep_for_init(init: int, part_count: int, ma: int, n: int) -> float:
    """Convert the paper's `init` parameter to a keep fraction.

    Reference README.md:335-342: keep = (init * K) / (ma * N) — init is the
    total number of codes exact-scanned per query; keep is the per-partition
    prefix fraction that achieves it.
    """
    if min(init, part_count, ma, n) <= 0:
        raise ValueError("all of init, part_count, ma, n must be positive")
    return (init * part_count) / (ma * n)


def train_coarse(key, learn_vectors, part_count: int, iters: int = 50,
                 balance_cap: float | None = None):
    """Learn the coarse quantizer (reference: learn_coarse_quantizer,
    databases.cpp:94-118 — OpenCV kmeans++ + 48 Lloyd iterations).

    balance_cap: optional ratio — bound the largest cell at balance_cap x
    the mean cell size by splitting oversized cells (K stays part_count;
    ops.kmeans.balance_centroids). A departure forced by static shapes:
    every partition is padded to the largest, so unbounded cell skew
    inflates the whole index (the reference's variable-length partitions
    never pay this). 3.0 is a
    good default for clustered data; None preserves plain Lloyd.
    """
    x = jnp.asarray(learn_vectors, jnp.float32)
    centroids, _ = kmeans(key, x, part_count, iters)
    if balance_cap is not None:
        from qadc_tpu.ops.kmeans import balance_centroids

        centroids, _ = balance_centroids(
            jax.random.fold_in(key, 0x6A1), x, centroids,
            cap_ratio=balance_cap,
        )
    return centroids


def compute_residuals(index: IVFIndex, vectors, assignments):
    """residual = vector - coarse_centroid[assignment] (databases.cpp:24-48)."""
    return jnp.asarray(vectors, jnp.float32) - index.coarse_centroids[assignments]


def add(index: IVFIndex, vectors, encode_batch: int = 262144) -> IVFIndex:
    """Assign -> residual -> encode -> scatter into partitions.

    Reference: index_db::add_vectors (databases.hpp:270-298). One-shot
    convenience wrapper over index.build.IVFBuilder — for STREAMED ingest
    (many chunks) use the builder directly so per-partition buffers append in
    place and tail padding happens once at finalize().
    """
    from qadc_tpu.index.build import IVFBuilder

    b = IVFBuilder.from_index(index)
    b.add(vectors, encode_batch=encode_batch)
    return b.finalize()


def _one_hot_gathered(codes, sq_count: int, sq_bits: int, dtype):
    """(..., S, code_bytes) uint8 -> (..., S, M*K) one-hot."""
    idx = unpack_codes(codes, sq_count, sq_bits)  # (..., S, M)
    k = 1 << sq_bits
    oh = jax.nn.one_hot(idx, k, dtype=dtype)
    return oh.reshape(*idx.shape[:-1], sq_count * k)


def assign_queries(index: IVFIndex, queries, ma: int):
    """(Q, ma) nearest partitions + (Q, ma, dim) rotated residual queries.

    Reference: index_db::assign_compute_residuals (databases.hpp:201-231) +
    OPQ rotation of residuals (query_common.hpp:289).
    """
    queries = jnp.asarray(queries, jnp.float32)
    _, parts = exact_knn(queries, index.coarse_centroids, ma)  # (Q, ma)
    residuals = queries[:, None, :] - index.coarse_centroids[parts]
    q, _, dim = residuals.shape
    rot = index.pq.rotate(residuals.reshape(q * ma, dim)).reshape(q, ma, dim)
    return parts, rot


def search_adc(
    index: IVFIndex, queries, r: int = 100, ma: int = 1,
    grouped: bool | None = None, group_size: int = 128,
    interpret: bool = False, scan_budget_bytes: int | None = None,
):
    """Conventional float ADC IVF search (reference: db_query.cpp).

    The grouped route (index.route) scans each probed partition once per
    batch: 4- and 8-bit through the plain-XLA window scan with float32
    tables at Precision.HIGHEST, then an exact-f32 rerank of whole winning
    windows; 16-bit as the squared distance to the PQ reconstruction
    (decode = per-sq row gathers; see index.flat._search_adc_recon) — the
    65536-entry tables and one-hots never materialize. The loop route is a
    one-hot x table product per probed partition.
    """
    # Probing more partitions than exist == probing all of them (the
    # reference's binheap assignment degrades unpredictably there; clamp).
    ma = min(ma, index.part_count)
    route = routes.choose("ivf_adc", index, grouped=grouped, interpret=interpret)
    bits = index.pq.sq_bits
    if route.path == "loop":
        return _search_adc_jnp_impl(index, queries, r, ma)
    if bits == 16:
        return _search_adc16_grouped_impl(index, queries, r, ma, group_size)
    m = index.pq.sq_count
    if bits == 4:
        impl, window, lanes, rerank_r = _search_adc4_grouped_impl, min(index.cpr, 16), m * 16, r
    else:
        impl, window, lanes, rerank_r = _search_adc8_grouped_impl, min(index.cpr, 8), m * 256, 0
    budget = _default_scan_budget() if scan_budget_bytes is None else scan_budget_bytes
    chunk = _governed_query_chunk(
        lambda qc: _grouped_scan_bytes(
            qc, ma, index.part_count, index.part_pad, window, group_size,
            lanes=lanes, slab_bytes=4, r=rerank_r, cb=index.pq.code_size,
        ),
        queries.shape[0], budget,
    )

    def run(qs):
        return impl(index, qs, r, ma, group_size)

    if chunk < queries.shape[0]:
        return _run_query_chunks(run, jnp.asarray(queries), chunk)
    return run(queries)


@partial(jax.jit, static_argnames=("r", "ma"))
def _search_adc_jnp_impl(index: IVFIndex, queries, r: int = 100, ma: int = 1):
    parts, rot = assign_queries(index, queries, ma)
    m = index.pq.sq_count
    wide = index.pq.sq_bits == 16
    if not wide:
        tables = adc_tables(rot, index.pq.centroids)  # (Q, ma, M, K)
        k = index.pq.sq_centroid_count
        tflat = tables.reshape(*tables.shape[:2], m * k)

    sizes = index.part_sizes[parts]  # (Q, ma)

    def scan_one_assignment(ass_i, carry):
        best_v, best_l = carry
        pids = jax.lax.dynamic_index_in_dim(parts, ass_i, 1, keepdims=False)
        pcodes = index.codes[pids].reshape(
            -1, index.part_pad, index.pq.code_size
        )                                              # (Q, part_pad, cb)
        plabels = index.labels[pids]                   # (Q, part_pad)
        if wide:
            from qadc_tpu.index.flat import decode_rows

            idx = unpack_codes(pcodes, m, 16)          # (Q, part_pad, M)
            dec = decode_rows(index.pq, idx)           # (Q, part_pad, dim)
            ra = jax.lax.dynamic_index_in_dim(rot, ass_i, 1, keepdims=False)
            cross = jnp.einsum(
                "qd,qsd->qs", ra, dec,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            d = (
                jnp.sum(ra * ra, axis=1)[:, None]
                + jnp.sum(dec * dec, axis=2)
                - 2.0 * cross
            )
        else:
            oh = _one_hot_gathered(pcodes, m, index.pq.sq_bits, jnp.float32)
            t = jax.lax.dynamic_index_in_dim(tflat, ass_i, 1, keepdims=False)
            d = jnp.einsum("qsf,qf->qs", oh, t, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        # Mask padded rows (duplicates of the last code would flood the top-r
        # at our padding granularity) and empty partitions.
        sz = jax.lax.dynamic_index_in_dim(sizes, ass_i, 1, keepdims=True)
        col = jnp.arange(index.part_pad, dtype=jnp.int32)
        d = jnp.where(col[None, :] < sz, d, jnp.inf)
        cv, cl = topk_smallest(d, plabels, min(r, index.part_pad))
        return merge_topk(best_v, best_l, cv, cl, r)

    q = queries.shape[0]
    init = (jnp.full((q, r), jnp.inf, jnp.float32), jnp.zeros((q, r), jnp.int32))
    vals, labs = jax.lax.fori_loop(0, ma, scan_one_assignment, init)
    return vals, labs


@partial(jax.jit, static_argnames=("r", "ma", "group_size", "window"))
def _search_adc8_grouped_impl(
    index: IVFIndex, queries, r: int, ma: int, group_size: int,
    window: int | None = None,
):
    """8-bit IVF ADC, grouped (MoE-style routing).

    The per-assignment path materializes (Q, part_pad, M*256) one-hots per
    probe step; here each probed partition is scanned once per batch by the
    plain-XLA window scan (f32 tables, Precision.HIGHEST). Window minima
    are screened at query level, then every member of each winning window is
    reranked with exact-f32 table gathers (a true top-r entry is lost only
    if its entire window misses the wq-window screen). Reference:
    scan_standard<uint8_t> over probed partitions (query_common.hpp:92-118).
    """
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)          # (Q, ma, M, 256) f32
    m = index.pq.sq_count
    q = queries.shape[0]
    qa = q * ma
    part_pad = index.part_pad
    if window is None:
        # The rerank's wq*window element gathers dominate, so windows stay
        # short. Untuned on the H100 (ROADMAP).
        window = min(index.cpr, 8)
    c = part_pad // window
    routed = route_queries(parts, index.part_count, group_size)
    cv = window_min_to_float(grouped_window_minima(
        index.codes, index.part_sizes, routed, tables.reshape(qa, m * 256),
        code_size=index.pq.code_size, part_pad=part_pad, window=window,
        scan="xla", sq_bits=8,
    ))                                                    # (QA, C)

    # Exact screen of wq windows across the query's ma partitions, then
    # expand each winning window and rerank EVERY member: top-wq windows by
    # true minimum with wq >= r provably contain every true top-r member's
    # window (r windows with smaller minima would hold r better codes). The
    # margin absorbs summation-order rounding between the scan and the
    # rerank near the cut; expansion volume is wq*window gathers per query.
    wq = min(r + max(16, r // 8), ma * c)
    screen_v, selq = exact_tile_screen(cv.reshape(q, ma * c), wq)
    sel_ai = selq // c
    sel_win = selq % c                                    # window in partition
    sel_pair = jnp.arange(q, dtype=jnp.int32)[:, None] * ma + sel_ai
    sel_part = _select_cols(parts, sel_ai, ma)            # (Q, wq)
    all_rows = sel_win[..., None] * window + jnp.arange(window, dtype=jnp.int32)
    sz_sel = index.part_sizes[sel_part]                   # (Q, wq)
    member_ok = (
        (all_rows < sz_sel[..., None]) & jnp.isfinite(screen_v)[..., None]
    )
    rows_cl = jnp.minimum(all_rows, jnp.maximum(sz_sel - 1, 0)[..., None])
    cand_global = (
        sel_part[..., None] * part_pad + rows_cl
    ).reshape(q, wq * window)                             # (Q, wq*window) code rows
    cand_lab = index.labels.reshape(-1)[cand_global]

    # Exact-f32 rerank: one flat element gather per (candidate, sub-quantizer)
    # from the per-pair f32 tables.
    cand_codes = gather_codes_row128(
        index.codes.reshape(-1, 128), cand_global, m
    )                                                     # (Q, wq*window, m) u8
    idx8 = unpack_codes(cand_codes, m, 8)                 # (Q, wq*window, m) int32
    tab_flat = tables.reshape(qa * m * 256)
    m_iota = jnp.arange(m, dtype=jnp.int32)
    pair_rep = jnp.repeat(sel_pair, window, axis=1)       # (Q, wq*window)
    flat_ix = (pair_rep[:, :, None] * m + m_iota) * 256 + idx8
    fd = jnp.sum(tab_flat[flat_ix], axis=-1)              # (Q, wq*window) f32
    fd = jnp.where(member_ok.reshape(q, wq * window), fd, jnp.inf)
    if r > wq * window:  # tiny probed volume: pad to the (Q, r) contract
        fd = jnp.pad(fd, [(0, 0), (0, r - wq * window)], constant_values=jnp.inf)
        cand_lab = jnp.pad(cand_lab, [(0, 0), (0, r - wq * window)])
    return topk_smallest(fd, cand_lab, r)


@partial(
    jax.jit,
    static_argnames=("r", "ma", "group_size", "window", "group_chunk"),
)
def _search_adc16_grouped_impl(
    index: IVFIndex, queries, r: int, ma: int, group_size: int,
    window: int = 8, group_chunk: int = 8,
):
    """16-bit IVF ADC, grouped: decode each DISTINCT probed partition once.

    The 65536-entry tables never materialize (reconstruction-GEMM scan, as
    flat._search_adc_recon); MoE routing means a partition probed by many
    queries is decoded once and GEMMed against its whole query group, vs the
    per-assignment path's Q*ma decodes. Chunked over groups (lax.map) so the
    decoded partitions and distance blocks stay O(group_chunk * part_pad).
    Per-window argmin candidates, exact reconstruction rerank of the 2r
    screened winners. Reference: scan_standard<uint16_t> over probed
    partitions (query_common.hpp:92-118).
    """
    from qadc_tpu.index.flat import decode_rows

    parts, rot = assign_queries(index, queries, ma)
    m = index.pq.sq_count
    cb = index.pq.code_size
    q = queries.shape[0]
    qa = q * ma
    dim = rot.shape[-1]
    part_pad = index.part_pad
    c = part_pad // window

    routed = route_queries(parts, index.part_count, group_size)
    gcap, g = routed.gcap, routed.group_size
    qa_g = routed.qa_group.reshape(qa)
    qa_s = routed.qa_slot.reshape(qa)
    slot_to_pair = jnp.zeros((gcap * g,), jnp.int32).at[qa_g * g + qa_s].set(
        jnp.arange(qa, dtype=jnp.int32)
    )
    rotq = rot.reshape(qa, dim)
    qslab = rotq[slot_to_pair].reshape(gcap, g, dim)

    gcap_pad = -(-gcap // group_chunk) * group_chunk
    gp = jnp.pad(routed.group_part, (0, gcap_pad - gcap))
    qslab = jnp.pad(qslab, [(0, gcap_pad - gcap), (0, 0), (0, 0)])

    def chunk_fn(ci):
        gp_c = jax.lax.dynamic_slice_in_dim(gp, ci * group_chunk, group_chunk)
        codes_c = index.codes[gp_c]                   # (ch, rows, 128) rows
        idx = unpack_codes(codes_c.reshape(group_chunk * part_pad, cb), m, 16)
        dec = decode_rows(index.pq, idx).reshape(group_chunk, part_pad, dim)
        qs_c = jax.lax.dynamic_slice_in_dim(qslab, ci * group_chunk, group_chunk)
        cross = jnp.einsum(
            "cpd,cgd->cgp", dec, qs_c,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        d = (
            jnp.sum(qs_c * qs_c, -1)[:, :, None]
            + jnp.sum(dec * dec, -1)[:, None, :]
            - 2.0 * cross
        )                                             # (ch, g, part_pad)
        dw = d.reshape(group_chunk, g, c, window)
        return jnp.min(dw, -1), jnp.argmin(dw, -1).astype(jnp.int32)

    mins, args = jax.lax.map(chunk_fn, jnp.arange(gcap_pad // group_chunk))
    vals_rows = mins.reshape(gcap_pad * g, c)[: gcap * g]
    arg_rows = args.reshape(gcap_pad * g, c)[: gcap * g]

    cv = vals_rows[qa_g * g + qa_s]                   # (QA, C)
    rows_local = (
        jnp.arange(c, dtype=jnp.int32)[None, :] * window
        + arg_rows[qa_g * g + qa_s]
    )                                                 # (QA, C) code order
    p_of_pair = parts.reshape(qa)
    sz = index.part_sizes[p_of_pair]
    # Windows are CONSECUTIVE codes here: valid iff the window starts before
    # the partition's real size; clamp padded argmins to the last real code
    # keeping only the window that contains it (flood dedup, see the 8-bit
    # grouped path).
    win_start = jnp.arange(c, dtype=jnp.int32)[None, :] * window
    win_has_valid = win_start < sz[:, None]
    clamped = rows_local >= sz[:, None]
    last = jnp.maximum(sz - 1, 0)
    keep = (~clamped) | (
        jnp.arange(c, dtype=jnp.int32)[None, :] == (last // window)[:, None]
    )
    cv = jnp.where(win_has_valid & keep, cv, jnp.inf)

    # wq >= r suffices under an exact screen (see the 8-bit path); the
    # margin absorbs decode/window-min rounding near the cut, and expansion
    # volume (wq*window decodes) is the dominant rerank cost.
    wq = min(r + max(16, r // 8), ma * c)
    cv_q = cv.reshape(q, ma * c)
    # EXACT window screen + whole-window expansion (same contract as the
    # 4/8-bit grouped paths): ranking only per-window argmins would lose
    # co-window top-r members on clustered data, and top-wq windows by true
    # min provably contain every true top-r member's window. Windows are
    # CONSECUTIVE codes, so expansion is win*window + arange(window).
    screen_v, selq = exact_tile_screen(cv_q, wq)
    sel_ai = selq // c
    sel_win = selq % c
    sel_pair = jnp.arange(q, dtype=jnp.int32)[:, None] * ma + sel_ai
    sel_part = _select_cols(parts, sel_ai, ma)
    all_rows = (
        sel_win[..., None] * window
        + jnp.arange(window, dtype=jnp.int32)
    )                                                 # (Q, wq, window) local
    sz_sel = index.part_sizes[sel_part]
    member_ok = (
        (all_rows < sz_sel[..., None]) & jnp.isfinite(screen_v)[..., None]
    )
    rows_cl = jnp.minimum(all_rows, jnp.maximum(sz_sel - 1, 0)[..., None])
    cand_global = (
        sel_part[..., None] * part_pad + rows_cl
    ).reshape(q, wq * window)
    cand_lab = index.labels.reshape(-1)[cand_global]

    # Exact reconstruction rerank of every member: decode wq*window codes
    # per query and measure against each candidate's own rotated residual
    # query.
    cand_codes = gather_codes_row128(
        index.codes.reshape(-1, 128), cand_global, cb
    )
    idx16 = unpack_codes(cand_codes, m, 16)           # (Q, wq*window, M)
    dec = decode_rows(index.pq, idx16)                # (Q, wq*window, dim)
    qvec = rotq[jnp.repeat(sel_pair, window, axis=1)]  # (Q, wq*window, dim)
    fd = jnp.sum((qvec - dec) ** 2, axis=-1)
    fd = jnp.where(member_ok.reshape(q, wq * window), fd, jnp.inf)
    if r > wq * window:
        fd = jnp.pad(fd, [(0, 0), (0, r - wq * window)], constant_values=jnp.inf)
        cand_lab = jnp.pad(cand_lab, [(0, 0), (0, r - wq * window)])
    return topk_smallest(fd, cand_lab, r)


@partial(jax.jit, static_argnames=("r", "ma", "group_size", "window"))
def _search_adc4_grouped_impl(
    index: IVFIndex, queries, r: int, ma: int, group_size: int,
    window: int | None = None,
):
    """4-bit conventional (float) ADC, grouped.

    The Quick-ADC grouped machinery with quantization skipped: f32 tables
    through the plain-XLA window scan (Precision.HIGHEST — TF32 would round
    the tables to three digits), top-wq window selection, and whole-window
    exact-f32 rerank (window_rerank). A code outside the top-wq windows is
    beaten by wq >= r codes, so the expansion contains the true top-r and the
    returned distances are exact f32. Reference: scan_4<NSQ> over probed
    partitions (query_common.hpp:59-90, db_query.cpp:17-46).
    """
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)          # (Q, ma, M, 16) f32
    m = index.pq.sq_count
    q = queries.shape[0]
    qa = q * ma
    part_pad = index.part_pad
    if window is None:
        window = min(index.cpr, 16)
    c = part_pad // window
    routed = route_queries(parts, index.part_count, group_size)
    cv = window_min_to_float(grouped_window_minima(
        index.codes, index.part_sizes, routed, tables.reshape(qa, m * 16),
        code_size=index.pq.code_size, part_pad=part_pad, window=window,
        scan="xla",
    ))                                                    # (QA, C)
    sz = index.part_sizes[parts]                          # (Q, ma)

    # wq = r: the screen minima and the rerank distances are the same float
    # ADC values up to summation order, so the top-r codes live in at most r
    # windows and any displacing window holds a better code (containment
    # note in _search_qadc_grouped_impl).
    wq = min(r, ma * c)
    screen_v, selq = exact_tile_screen(cv.reshape(q, ma * c), wq)
    sel_ai = selq // c
    sel_wi = selq % c
    sel_pair = jnp.arange(q, dtype=jnp.int32)[:, None] * ma + sel_ai
    sel_part = _select_cols(parts, sel_ai, ma)
    sel_sz = _select_cols(sz, sel_ai, ma)
    return window_rerank(
        index.codes.reshape(-1, 128), index.labels.reshape(-1), part_pad,
        tables, screen_v, sel_part, sel_pair, sel_wi, sel_sz, r, window,
    )


@partial(jax.jit, static_argnames=("r", "ma", "keep", "prefix_pad", "rerank", "saturate"))
def _search_qadc_impl(
    index: IVFIndex, queries, r: int, ma: int, keep: float, prefix_pad: int,
    rerank: bool, saturate: bool = False, bound=None,
):
    # Shared front half: assign, tables, keep-prefix bound (db_query_4.cpp:
    # 230-242), QuantizerMAX int8 quantize (db_query_4.cpp:256-284).
    parts, tables, qtables, _ = _quantized_tables(index, queries, r, ma,
                                                  keep, prefix_pad,
                                                  bound_override=bound)
    m = index.pq.sq_count
    q = queries.shape[0]
    sizes = index.part_sizes[parts]  # (Q, ma)
    tflat = tables.reshape(*tables.shape[:2], m * 16)
    qtflat = qtables.reshape(q, ma, m * 16)

    # ---- int8 screen of each probed partition (+ optional float rerank of
    # the screened candidates), merged top-r. The int8 scan is unsaturated
    # (int32 accumulation, strictly more informative than the reference's
    # saturating adds); rerank recovers the per-entry truncation loss.
    rr = min((2 * r) if rerank else r, index.part_pad)

    def scan_one_assignment(ass_i, carry):
        best_v, best_l = carry
        pids = jax.lax.dynamic_index_in_dim(parts, ass_i, 1, keepdims=False)
        pcodes = index.codes[pids].reshape(-1, index.part_pad, index.pq.code_size)
        plabels = index.labels[pids]
        ohc = _one_hot_gathered(pcodes, m, 4, jnp.int8)
        qt = jax.lax.dynamic_index_in_dim(qtflat, ass_i, 1, keepdims=False)
        acc = jnp.einsum(
            "qsf,qf->qs", ohc, qt, preferred_element_type=jnp.int32
        )
        if saturate:
            # Reference saturating-int8 adds (simd_scan.hpp:161): entries are
            # >= 0, so the sequential saturated sum == min(sum, 127).
            acc = jnp.minimum(acc, 127)
        acc = acc.astype(jnp.float32)
        sz = jax.lax.dynamic_index_in_dim(sizes, ass_i, 1, keepdims=True)
        col = jnp.arange(index.part_pad, dtype=jnp.int32)
        d = jnp.where(col[None, :] < sz, acc, jnp.inf)
        neg_top, rows = jax.lax.top_k(-d, rr)           # (Q, rr) screened rows
        cl = jnp.take_along_axis(plabels, rows, axis=-1)
        if rerank:
            t = jax.lax.dynamic_index_in_dim(tflat, ass_i, 1, keepdims=False)
            cand_oh = jnp.take_along_axis(
                ohc, rows[:, :, None], axis=1
            ).astype(jnp.float32)                        # (Q, rr, M*16)
            cv = jnp.einsum(
                "qcf,qf->qc", cand_oh, t, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            cv = jnp.where(jnp.isfinite(-neg_top), cv, jnp.inf)
        else:
            cv = -neg_top
        return merge_topk(best_v, best_l, cv, cl, r)

    init = (jnp.full((q, r), jnp.inf, jnp.float32), jnp.zeros((q, r), jnp.int32))
    vals, labs = jax.lax.fori_loop(0, ma, scan_one_assignment, init)
    return vals, labs


def tile_tables_rows(tables_qa3):
    """Per-pair float tables in COMPACT j-major lane layout.

    Args:
      tables_qa3: (QA, M, 16) float32 per-(query, assignment) tables.

    Returns:
      (tlo_c, thi_c): each (QA, 16*cb) f32 where lane j*cb + b holds
      table[sq 2b (lo) / 2b+1 (hi), centroid j]. COMPACT on purpose: the
      rerank gathers one row per selected window, and compact rows are 16x
      smaller than rows pre-tiled to the 128 byte lanes; rows_adc tiles them.
    """
    qa, m, k = tables_qa3.shape
    assert k == 16
    cb = m // 2
    tev = tables_qa3[:, 0::2, :].transpose(0, 2, 1)   # (QA, 16, cb) even sqs
    tod = tables_qa3[:, 1::2, :].transpose(0, 2, 1)
    return tev.reshape(qa, 16 * cb), tod.reshape(qa, 16 * cb)


def rows_adc(rows, tlo_c, thi_c, cb: int):
    """Exact float ADC distances for whole ROW128 storage rows.

    Select-accumulate over the 16 centroid ids on full 128-byte rows (XLA
    fuses the loop into one elementwise pass), then a per-code byte
    reduction.

    Args:
      rows: (A, 128) uint8 — packed 4-bit codes, cpr codes per row.
      tlo_c/thi_c: (A, 16*cb) f32 — per-row COMPACT tables (lane j*cb + b)
        from tile_tables_rows, already gathered to row granularity.

    Returns:
      (A, cpr) float32 distances, one per code in each row.
    """
    a = rows.shape[0]
    cpr = 128 // cb
    lo = (rows & 0x0F).astype(jnp.int32)     # lane l = c*cb + b -> sq 2b
    hi = (rows >> 4).astype(jnp.int32)       #                  -> sq 2b+1
    acc = jnp.zeros((a, 128), jnp.float32)
    for j in range(16):
        tl = jnp.concatenate([tlo_c[:, j * cb : (j + 1) * cb]] * cpr, axis=1)
        th = jnp.concatenate([thi_c[:, j * cb : (j + 1) * cb]] * cpr, axis=1)
        acc = acc + jnp.where(lo == j, tl, 0.0)
        acc = acc + jnp.where(hi == j, th, 0.0)
    # Per-code byte reduction as a tiny selector matmul (S[l, c] = l//cb == c);
    # HIGHEST keeps f32-exact sums (TF32 would perturb the ranking).
    s_mat = jnp.asarray(
        (np.arange(128)[:, None] // cb) == np.arange(cpr)[None, :], jnp.float32
    )
    return jnp.dot(acc, s_mat, precision=jax.lax.Precision.HIGHEST)


def _quantized_tables(index, queries, r, ma, keep, prefix_pad,
                      bound_override=None):
    """Shared front half: assign, tables, keep-prefix bound, int8 quantize.

    bound_override: optional (Q,) f32 — per-query quantization bound used
    INSTEAD of the keep-prefix estimate (the prefix scan is skipped). Lets
    callers with external knowledge (a previous pass's r-th distance — the
    batched analog of the reference's intra-scan bound tightening,
    simd_scan.hpp:76-118 — or a recorded bound) sharpen int8 resolution:
    delta = (bound - qmin)/127, so a 2x tighter bound halves the
    quantization step everywhere below it.

    Returns (parts (Q, ma), tables f32 (Q, ma, M, 16), qtables int8,
    (tlo_full, thi_full) row-tiled float tables for reuse by the rerank).
    """
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)
    m = index.pq.sq_count
    q = queries.shape[0]
    qa = q * ma
    sizes = index.part_sizes[parts]
    cb = index.pq.code_size
    cpr = index.cpr
    tlo_full, thi_full = tile_tables_rows(tables.reshape(qa, m, 16))

    if bound_override is None:
        starts_sizes = jnp.maximum(
            1, (sizes.astype(jnp.float32) * keep).astype(jnp.int32)
        )
        starts_sizes = jnp.where(sizes > 0, starts_sizes, 0)
        # Keep-prefix distances via whole-ROW128-row gathers + full-row
        # select-accumulate (rows_adc): no element gathers, tables tiled once
        # and shared with the rerank stage.
        rows_per_part = index.part_pad // cpr
        ppr = -(-prefix_pad // cpr)              # prefix rows per partition
        prow = (
            parts.reshape(qa)[:, None] * rows_per_part
            + jnp.arange(ppr, dtype=jnp.int32)[None, :]
        ).reshape(qa * ppr)
        rows = index.codes.reshape(-1, 128)[prow]           # (QA*ppr, 128)
        pair_of_row = (
            jnp.arange(qa, dtype=jnp.int32)[:, None]
            .repeat(ppr, axis=1).reshape(qa * ppr)
        )
        pd = rows_adc(rows, tlo_full[pair_of_row], thi_full[pair_of_row], cb)
        pd = pd.reshape(q, ma, ppr * cpr)
        col = jnp.arange(ppr * cpr, dtype=jnp.int32)
        valid = col[None, None, :] < starts_sizes[:, :, None]
        bound = keep_prefix_bound(
            pd.reshape(q, ma * ppr * cpr), r, valid.reshape(q, ma * ppr * cpr)
        )
    else:
        bound = jnp.asarray(bound_override, jnp.float32).reshape(q)

    tables_nn = jnp.maximum(tables, 0.0)
    max_possible = jnp.max(jnp.sum(jnp.max(tables_nn, axis=-1), axis=-1), axis=-1)
    bound = clamp_bound_to_max_distance(bound, max_possible)
    qmin = jnp.min(tables_nn, axis=(-3, -2, -1))
    qtables = quantize_tables_int8(
        tables, bound[:, None, None, None], qmin[:, None, None, None]
    )
    return parts, tables, qtables, (tlo_full, thi_full)


# Memory governor for the grouped scan paths: the reference sizes its query
# batch so the distance tables fit a 1 GiB buffer (TABLES_BUFFER_SIZE,
# query_common.hpp:147,171-175). The grouped scan's dominant transients —
# the (gcap*G, C) window-minimum output, the (QA, C) per-pair gather, and the
# (gcap*G, lanes) table slabs — all scale with the query count, so a large
# b x ma config is CHUNKED over queries to stay within this budget instead of
# discovering OOM at runtime.
#
# The budget tracks the DEVICE, not a constant: chunking costs throughput on
# sparse-probe shapes (each chunk re-pays the G-wide group slab for its few
# live queries), so the default is a fraction of the accelerator's memory
# limit with the constant as the floor/fallback.
SCAN_BUDGET_BYTES = 2 << 30
_scan_budget_cache: int | None = None


def _default_scan_budget() -> int:
    """35% of the device memory limit, floored at SCAN_BUDGET_BYTES.

    QADC_SCAN_BUDGET_BYTES overrides everything for exotic deployments.
    """
    global _scan_budget_cache
    if _scan_budget_cache is None:
        env = os.environ.get("QADC_SCAN_BUDGET_BYTES")
        if env:
            _scan_budget_cache = int(env)
            return _scan_budget_cache
        budget = SCAN_BUDGET_BYTES
        stats = jax.devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
        if limit:
            budget = max(budget, int(limit * 0.35))
        _scan_budget_cache = budget
    return _scan_budget_cache


def _grouped_scan_bytes(
    q: int, ma: int, part_count: int, part_pad: int, window: int,
    group_size: int, lanes: int, slab_bytes: int, r: int = 0, cb: int = 0,
    prefix_pad: int = 0,
) -> int:
    """Estimated transient device bytes of one grouped scan call.

    With r and cb set, also counts the rerank tail — window_rerank's
    candidate gathers scale with q*wq: per selected window, one (128,) u8
    code row, one (cpr,) label row, two (16*cb,) f32 compact table rows, and
    the (cpr,) rows_adc output. prefix_pad adds the keep-prefix bound scan's
    row/table gathers (qadc only).
    """
    qa = q * ma
    gcap = group_capacity(q, ma, part_count, group_size)
    c = part_pad // window
    vals = gcap * group_size * c * 4
    gathered = qa * c * 4
    slabs = gcap * lanes * group_size * slab_bytes
    total = vals + gathered + slabs
    if r and cb:
        cpr = 128 // cb
        table_row = 2 * 16 * cb * 4
        a = q * min(r, ma * c)              # selected windows (wq = r)
        total += a * (128 + cpr * 4 + table_row + cpr * 4)
        if prefix_pad:
            pre = qa * (-(-prefix_pad // cpr))  # prefix rows scanned
            total += pre * (128 + table_row + cpr * 4)
    return total


def _governed_query_chunk(bytes_fn, q: int, budget: int) -> int:
    """Largest power-of-two chunk <= q whose scan transients fit the budget."""
    chunk = 1 << max(0, (q - 1).bit_length())
    while chunk > 1 and bytes_fn(min(chunk, q)) > budget:
        chunk //= 2
    return min(chunk, q)


def _run_query_chunks(search_one, queries, chunk: int, bounds=None):
    """Run fixed-shape query chunks (jit compiles once; tail padded).

    bounds: optional (Q,) per-query values passed along with each chunk.
    """
    q = queries.shape[0]
    out_d, out_l = [], []
    for s in range(0, q, chunk):
        batch = queries[s : s + chunk]
        real = batch.shape[0]
        if real < chunk:
            batch = jnp.pad(batch, [(0, chunk - real), (0, 0)])
        if bounds is None:
            d, l = search_one(batch)
        else:
            bd = bounds[s : s + chunk]
            d, l = search_one(batch, jnp.pad(bd, (0, chunk - real)))
        out_d.append(d[:real])
        out_l.append(l[:real])
    if len(out_d) == 1:
        return out_d[0], out_l[0]
    return jnp.concatenate(out_d), jnp.concatenate(out_l)


@partial(jax.jit, static_argnames=("r", "ma"))
def _search_qadc_direct_impl(index: IVFIndex, queries, r: int, ma: int):
    """Small-batch low-latency path: EXACT float ADC over all probed codes.

    The reference's per-query engine (query_common.hpp:245-309, b=1 default
    at db_query_4.cpp:331) exists because single-query latency matters; the
    screened pipeline's many stages cost fixed launch latency at b=1. This
    path is three stages: assign+tables, one rows_adc pass over the ma probed
    partitions (each row ranked with its own pair's float table), then an
    exact screen that is also the final ranking.

    Distance VALUES are exact float ADC everywhere, and the screen is
    ORACLE-EXACT (ops.topk.exact_tile_screen — provable containment of the
    probed top-r).
    """
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)         # (Q, ma, M, 16)
    m = index.pq.sq_count
    q = queries.shape[0]
    qa = q * ma
    cb = index.pq.code_size
    cpr = index.cpr
    rpp = index.part_pad // cpr                           # rows per partition
    tlo, thi = tile_tables_rows(tables.reshape(qa, m, 16))
    pflat = parts.reshape(qa)
    grow = (
        pflat[:, None] * rpp + jnp.arange(rpp, dtype=jnp.int32)[None, :]
    ).reshape(qa * rpp)
    rows = index.codes.reshape(-1, 128)[grow]             # (QA*rpp, 128)
    pair = jnp.repeat(jnp.arange(qa, dtype=jnp.int32), rpp)
    d = rows_adc(rows, tlo[pair], thi[pair], cb)          # (QA*rpp, cpr)
    # Flat column f of a query = a*part_pad + code id (storage-row order).
    # Finite sentinel (not +inf): the sentinel flows through the screen when
    # fewer than wq valid candidates exist, and 0 * inf would NaN any matmul
    # it later touched; restored to +inf after the screen.
    big = jnp.float32(MASK_BIG)
    sz = index.part_sizes[parts]                          # (Q, ma)
    col = jnp.arange(index.part_pad, dtype=jnp.int32)
    valid = (col[None, None, :] < sz[:, :, None]).reshape(q, ma * index.part_pad)
    width = ma * index.part_pad
    d = jnp.where(valid, d.reshape(q, width), big)
    # EXACT screen (ops.topk.exact_tile_screen): provably captures the
    # probed top-r, and returns values ASCENDING with their columns, so its
    # output IS the final ranking (wq == r, no second top-k).
    wq = min(r, width)
    sv, col = exact_tile_screen(d, wq)                    # (Q, wq) global col
    if r > wq:  # tiny probed volume: pad to the (Q, r) contract
        sv = jnp.pad(sv, [(0, 0), (0, r - wq)], constant_values=big)
        col = jnp.pad(col, [(0, 0), (0, r - wq)])
    a_id = col // index.part_pad                          # assignment index
    code_local = col % index.part_pad
    part_sel = jnp.take_along_axis(parts, a_id, axis=1)   # (Q, r)
    fl = index.labels.reshape(-1)[part_sel * index.part_pad + code_local]
    # Dead slots (r > valid candidates, or the r > wq pad above whose col=0
    # gathers a REAL label) return -1, the missing-result sentinel —
    # a caller not filtering on inf must not see a spurious genuine label.
    return (
        jnp.where(sv >= big, jnp.inf, sv),
        jnp.where(sv >= big, jnp.int32(-1), fl),
    )


@partial(
    jax.jit,
    static_argnames=("r", "ma", "keep", "prefix_pad", "rerank", "group_size",
                     "window", "scan", "block_n", "saturate"),
)
def _search_qadc_grouped_impl(
    index: IVFIndex, queries, r: int, ma: int, keep: float, prefix_pad: int,
    rerank: bool, group_size: int, window: int, scan: str,
    block_n: int = DEFAULT_BLOCK_N, saturate: bool = False, bound=None,
):
    """Partition-grouped Quick-ADC IVF search.

    MoE-style routing (index/routing.py) turns per-query partition probes into
    per-partition query groups; each group's partition is scanned ONCE
    against its G query tables by the window scan (kernels/window_scan.py).
    Replaces the reference's per-query scan loop (db_query_4.cpp:287-308)
    with batched products.
    """
    parts, tables, qtables, tiles = _quantized_tables(
        index, queries, r, ma, keep, prefix_pad, bound_override=bound,
    )
    q = queries.shape[0]
    m = index.pq.sq_count
    qa = q * ma
    part_pad = index.part_pad
    c = part_pad // window

    routed = route_queries(parts, index.part_count, group_size)
    cv = window_min_to_float(grouped_window_minima(
        index.codes, index.part_sizes, routed, qtables.reshape(qa, m * 16),
        code_size=index.pq.code_size, part_pad=part_pad, window=window,
        scan=scan, block_n=block_n,
    ), saturate=saturate)                                 # (QA, C)
    sz = index.part_sizes[parts]                          # (Q, ma)

    # Merge windows at QUERY level (top wq windows across the query's ma
    # partitions), then expand EVERY code of each winning window and rank
    # those (quantization ties inside a window are harmless; candidate volume
    # stays Q x r x W instead of Q x ma x r x W).
    #
    # wq = r is SUFFICIENT with an exact screen: any window displacing a
    # top-r code's window has a smaller true minimum, i.e. holds a better
    # code itself — at most r windows can hold the quantized top-r. Exactness
    # matters twice: (1) the containment argument; (2) no-rerank mode must
    # rank by quantized distance exactly (reference semantics).
    wq = min(r, ma * c)
    screen_v, selq = exact_tile_screen(cv.reshape(q, ma * c), wq)
    sel_ai = selq // c                                     # assignment index
    sel_wi = selq % c                                      # window in partition
    sel_pair = jnp.arange(q, dtype=jnp.int32)[:, None] * ma + sel_ai  # (Q, wq)
    sel_part = _select_cols(parts, sel_ai, ma)             # (Q, wq)
    sel_sz = _select_cols(sz, sel_ai, ma)

    tw_src = tables if rerank else qtables.astype(jnp.float32)
    return window_rerank(
        index.codes.reshape(-1, 128), index.labels.reshape(-1), part_pad,
        tw_src, screen_v, sel_part, sel_pair, sel_wi, sel_sz, r, window,
        tiles=tiles if rerank else None, clamp127=saturate and not rerank,
    )


def grouped_window_minima(
    codes, part_sizes, routed, pair_tables, *, code_size: int, part_pad: int,
    window: int, scan: str, block_n: int = DEFAULT_BLOCK_N, sq_bits: int = 4,
):
    """Window minima of every (query, assignment) pair's probed partition.

    Scatters the per-pair table rows into (gcap*G, lanes) group slabs
    (scatter the pair ids, gather the rows), scans each live group's
    partition once (kernels.window_scan), and gathers each pair's slot row.

    Args:
      codes: (P, part_pad/cpr, 128) or (P*part_pad/cpr, 128) uint8 storage.
      part_sizes: (P,) int32.
      routed: index.routing.RoutedBatch of the (Q, ma) probes.
      pair_tables: (QA, lanes) per-pair tables (int8 or float32).

    Returns:
      (QA, part_pad // window) raw window minima (window_min_to_float).
    """
    gcap, g = routed.gcap, routed.group_size
    qa = routed.qa_group.size
    slot = routed.qa_group.reshape(qa) * g + routed.qa_slot.reshape(qa)
    slot_to_pair = jnp.zeros((gcap * g,), jnp.int32).at[slot].set(
        jnp.arange(qa, dtype=jnp.int32)
    )
    group_sizes = jnp.where(
        routed.group_valid, part_sizes[routed.group_part], 0
    )
    vals = window_min_scan(
        codes.reshape(-1, 128), routed.group_part, group_sizes,
        pair_tables[slot_to_pair], code_size=code_size,
        rows_per_group=part_pad, window=window, mode=scan, block_n=block_n,
        sq_bits=sq_bits,
    )
    return vals[slot]


def _select_cols(src, idx, ncols: int):
    """(Q, ncols) source, (Q, K) int column ids -> (Q, K) selected values.

    ncols where-accumulate passes: elementwise work that fuses, in place of
    a (Q, K) element gather, when ncols is small.
    """
    out = jnp.zeros(idx.shape, src.dtype)
    for a in range(ncols):
        out = out + jnp.where(idx == a, src[:, a : a + 1], 0)
    return out


def window_rerank(
    codes_rows, labels_flat, part_pad: int,
    tables_qa, screen_v, sel_part, sel_pair, sel_wi, sel_sz,
    r: int, window: int, tiles=None, clamp127: bool = False,
):
    """Expand winning windows to their codes and rank by exact float distance.

    Windows are `window` consecutive codes, and window | cpr, so all codes of
    one window live in ONE 128-byte ROW128 storage row: window w is row
    w // cs, in-row positions [(w % cs)*window, (w % cs + 1)*window) with
    cs = cpr / window. The rerank therefore needs only row gathers: one
    (A, 128) codes-row gather, one (A, cpr) labels-row gather, and one row
    gather of per-pair compact tables.

    Args:
      codes_rows/labels_flat: (P*part_pad/cpr, 128) row128 codes /
        (P*part_pad,) labels, partition-major.
      tables_qa: (Q, ma, M, 16) float tables to rank with (float tables for
        rerank, quantized-as-float for reference-style ranking).
      screen_v: (Q, wq) screened window minima (inf = dead slot).
      sel_part/sel_pair/sel_wi/sel_sz: (Q, wq) selected windows' partition id,
        flattened (q*ma+a) pair id, window id, and partition real size.

    Returns (dists (Q, r), labels (Q, r)).
    """
    q, wq = screen_v.shape
    m = tables_qa.shape[2]
    cb = m // 2
    cpr = 128 // cb
    if cpr % window != 0:
        raise ValueError(
            f"window {window} must divide codes-per-row {cpr} (row-gather rerank)"
        )
    qa = tables_qa.shape[0] * tables_qa.shape[1]
    a = q * wq                                   # selected windows (rows)
    cs = cpr // window                           # windows per storage row
    wi = sel_wi.reshape(a)
    rloc = wi // cs                              # storage row within partition
    c0 = wi % cs                                 # window within the row
    grow = sel_part.reshape(a) * (part_pad // cpr) + rloc

    rows = codes_rows[grow]                      # (A, 128) u8  [row gather]
    lab = labels_flat.reshape(-1, cpr)[grow]     # (A, cpr)     [row gather]

    if tiles is None:
        tiles = tile_tables_rows(tables_qa.reshape(qa, m, 16))
    tlo_full, thi_full = tiles
    pair = sel_pair.reshape(a)
    cvf = rows_adc(rows, tlo_full[pair], thi_full[pair], cb)        # (A, cpr)
    if clamp127:
        # Saturating-int8 reference semantics (simd_scan.hpp:161): table
        # entries are >= 0, so sequential saturating adds == min(sum, 127).
        cvf = jnp.minimum(cvf, 127.0)

    c_iota = jnp.arange(cpr, dtype=jnp.int32)
    alive = (
        ((c_iota[None, :] // window) == c0[:, None])              # own window
        & ((rloc[:, None] * cpr + c_iota[None, :]) < sel_sz.reshape(a)[:, None])
        & jnp.isfinite(screen_v).reshape(a)[:, None]
    )
    cvf = jnp.where(alive, cvf, jnp.inf)
    cvf = cvf.reshape(q, wq * cpr)
    labq = lab.reshape(q, wq * cpr)
    if r > wq * cpr:  # tiny probed volume: pad to the (Q, r) contract
        cvf = jnp.pad(cvf, [(0, 0), (0, r - wq * cpr)], constant_values=jnp.inf)
        labq = jnp.pad(labq, [(0, 0), (0, r - wq * cpr)])
    return topk_smallest(cvf, labq, r)


def search_qadc(
    index: IVFIndex, queries, r: int = 100, ma: int = 1, keep: float = 0.01,
    rerank: bool = True, grouped: bool | None = None, group_size: int = 128,
    grouped_window: int | None = None, interpret: bool = False,
    saturate: bool = False, direct: bool | None = None,
    scan_budget_bytes: int | None = None,
    block_n: int | None = None, bound=None,
):
    """Quick-ADC IVF search (reference: db_query_4.cpp; requires sq_bits==4).

    The route (grouped, direct or per-assignment loop) and the scan
    implementation come from index.route.choose.

    rerank: float-rerank the int8-screened candidates (see flat.search_qadc)
    — default on; pass False for reference-style ranking by quantized
    distance.
    grouped: use the partition-grouped window-scan path (default: on the GPU
    when the geometry allows).
    saturate: reproduce the reference's saturating int8 accumulation exactly
    (simd_scan.hpp:161) — quantized sums clamp at 127. Entries are >= 0, so
    min(sum, 127) equals the sequential saturated sum; the clamp composes
    with the window-min reduction.
    direct: small-batch low-latency path — exact float ADC over all probed
    codes in three stages (the batched answer to the reference's per-query
    b=1 engine, query_common.hpp:245-309). Default: on the GPU when rerank is
    on, saturate is off, and the probed volume is small
    (index.route.DIRECT_MAX_CODES). Results rank by exact distance, so
    recall >= the screened pipeline's.
    interpret: run the scan kernel in the Pallas interpreter and take the
    GPU's default routes (CPU tests only; raises on an accelerator).
    scan_budget_bytes: memory governor — grouped-path query batches whose
    scan transients would exceed this are chunked (default: a share of the
    device memory, the analog of the reference's TABLES_BUFFER_SIZE batch
    sizing, query_common.hpp:147,171-175).
    block_n: codes per scan-kernel program (grouped route).
    bound: optional (Q,) f32 per-query int8 quantization bound replacing the
    keep-prefix estimate (the prefix scan is skipped) — the batched analog
    of the reference's intra-scan bound tightening (simd_scan.hpp:76-118): a
    caller can pass a previous pass's r-th distance for finer int8
    resolution (see _quantized_tables). Ignored by the direct path, whose
    ranking is exact float and needs no bound; pass direct=False to force
    the quantized pipeline when measuring bound effects.

    Returns (dists (Q, r) float32, labels (Q, r) int32).
    """
    if index.pq.sq_bits != 4:
        raise ValueError("Quick ADC requires sq_bits == 4")
    # Probing more partitions than exist == probing all of them.
    ma = min(ma, index.part_count)
    q = queries.shape[0]
    route = routes.choose(
        "ivf_qadc", index, q=q, ma=ma, rerank=rerank, saturate=saturate,
        grouped=grouped, direct=direct, interpret=interpret,
    )
    budget = _default_scan_budget() if scan_budget_bytes is None else scan_budget_bytes
    if route.path == "direct":
        # Memory governor for the direct path: its dominant transient is the
        # (q, ma*part_pad) distance matrix plus the valid mask and screen
        # intermediates (~9 bytes per probed code) — chunk the query batch
        # so sparse-probe large-volume configs stay within budget.
        chunk = _governed_query_chunk(
            lambda qc: qc * ma * index.part_pad * 9, q, budget
        )

        def run_direct(qs):
            return _search_qadc_direct_impl(index, qs, r, ma)

        if chunk < q:
            return _run_query_chunks(run_direct, jnp.asarray(queries), chunk)
        return run_direct(queries)
    prefix_pad = max(1, int(index.max_part_size * keep)) if index.max_part_size else 1
    prefix_pad = min(prefix_pad, index.part_pad)
    if route.path == "loop":
        return _search_qadc_impl(
            index, queries, r, ma, keep, prefix_pad, rerank, saturate=saturate,
            bound=bound,
        )
    if block_n is None or grouped_window is None:
        # Measured per-geometry pick, if one was tuned and recorded
        # (qadc_tpu/autotune.py); the fixed defaults below otherwise.
        from qadc_tpu import autotune as _autotune

        pick = _autotune.lookup(_autotune.geometry_key(index, "ivf_qadc_grouped", q))
        if not pick and _autotune.enabled() and route.scan == "triton":
            pick = _autotune.tune_ivf_qadc(index, queries, r=r, ma=ma, keep=keep)
        if block_n is None:
            block_n = pick.get("block_n", DEFAULT_BLOCK_N)
        if grouped_window is None:
            grouped_window = pick.get("grouped_window")
    if grouped_window is None:
        # Windows == whole ROW128 storage rows (or an even split of one):
        # the rerank gathers exactly one row per window (see window_rerank).
        grouped_window = min(index.cpr, DEFAULT_WINDOW)

    def run(qs, bd=None):
        return _search_qadc_grouped_impl(
            index, qs, r, ma, keep, prefix_pad, rerank, group_size,
            grouped_window, route.scan, saturate=saturate, block_n=block_n,
            bound=bd,
        )

    lanes = index.pq.sq_count * 16
    chunk = _governed_query_chunk(
        lambda qc: _grouped_scan_bytes(
            qc, ma, index.part_count, index.part_pad, grouped_window,
            group_size, lanes, slab_bytes=1, r=r, cb=index.pq.code_size,
            prefix_pad=prefix_pad,
        ),
        q, budget,
    )
    if chunk < q:
        bounds = None if bound is None else jnp.asarray(bound, jnp.float32)
        return _run_query_chunks(run, jnp.asarray(queries), chunk, bounds)
    return run(queries, bound)
