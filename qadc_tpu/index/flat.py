"""Flat (exhaustive) index: one partition holding all codes.

Reference: flat_db (databases.hpp:77-167) — "assignment" is the identity (the
query is its own residual, databases.hpp:93-116), add = parallel encode into a
growing code buffer. Codes live device-side in ROW128 storage (16 codes per
128-byte row for 8-byte codes — core/layout.py); add re-pads host-side
(append-only); search is jitted.

Search paths (reference: scanner_simple db_query.cpp:17-46, scanner_4
db_query_4.cpp:73-310):
  - search_adc:  float ADC over all codes (any sq_bits) + exact top-r.
  - search_qadc: keep-prefix float scan -> per-query int8 bound -> QuantizerMAX
    table quantization -> int8 window scan (kernels/window_scan.py on the
    GPU, a chunked plain scan elsewhere; index.route decides) -> top-r.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from qadc_tpu.core.layout import DEFAULT_BLOCK, codes_per_row
from qadc_tpu.core.packing import gather_codes_row128, row128_to_codes, unpack_codes
from qadc_tpu.index import route as routes
from qadc_tpu.kernels.scan_ref import adc_scan_f32, scan_topk_f32, scan_topk_int8
from qadc_tpu.kernels.window_scan import (
    DEFAULT_WINDOW,
    window_min_scan,
    window_min_to_float,
)
from qadc_tpu.ops.quantization import (
    clamp_bound_to_max_distance,
    keep_prefix_bound,
    quantize_tables_int8,
)
from qadc_tpu.ops.tables import adc_tables
from qadc_tpu.ops.topk import exact_tile_screen, merge_topk, topk_smallest
from qadc_tpu.quantizers.pq import ProductQuantizer

# Widest query group one scan program serves (kernel registers bound it).
MAX_GROUP = 128


def _flat_range_count(n_pad: int, qp: int, window: int, budget: int) -> int:
    """Code-axis ranges so the scan's (Qp, range/W) window-min output fits
    the scan budget (index.ivf.SCAN_BUDGET_BYTES — the reference's
    TABLES_BUFFER_SIZE analog). At 100M codes the minima alone are GBs even
    at small batches without chunking; ranges scan sequentially and merge
    their top-r."""
    nr = 1
    while (
        (n_pad // nr) // window * qp * 4 > budget
        and (n_pad // (nr * 2)) % DEFAULT_BLOCK == 0
    ):
        nr *= 2
    return nr


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["pq", "codes"],
    meta_fields=["n"],
)
@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Flat index.

    Attributes:
      pq: ProductQuantizer (or OPQQuantizer).
      codes: (N_pad/cpr, 128) uint8 ROW128 storage (cpr = 128/code_size);
        padded tail repeats the last code (labels clamp to n-1, reference
        quirk simd_scan.hpp:67).
      n: real (unpadded) vector count — static.
    """

    pq: ProductQuantizer
    codes: jax.Array
    n: int

    @property
    def cpr(self) -> int:
        return codes_per_row(self.pq.code_size)

    @property
    def n_pad(self) -> int:
        return self.codes.shape[0] * self.cpr

    @classmethod
    def create(cls, pq: ProductQuantizer) -> "FlatIndex":
        """Empty index (reference: flatdb_create.cpp:39-66)."""
        cpr = codes_per_row(pq.code_size)
        return cls(
            pq=pq,
            codes=jnp.zeros((DEFAULT_BLOCK // cpr, 128), jnp.uint8),
            n=0,
        )

    @property
    def labels(self):
        """(N_pad,) int32, padded tail clamped to n-1."""
        lab = jnp.arange(self.n_pad, dtype=jnp.int32)
        return jnp.minimum(lab, max(self.n - 1, 0))


def add(index: FlatIndex, vectors, encode_batch: int = 262144) -> FlatIndex:
    """Encode and append vectors (reference: flat_db::add_vectors,
    databases.hpp:136-156 — OpenMP threads become device-side batches).

    One-shot wrapper over index.build.FlatBuilder; for streamed multi-chunk
    ingest use the builder directly (one concat + re-layout at finalize).
    """
    from qadc_tpu.index.build import FlatBuilder

    b = FlatBuilder.from_index(index)
    b.add(vectors, encode_batch=encode_batch)
    return b.finalize()


def _exact_rerank(tables, cand_codes, sq_bits: int):
    """Exact f32 ADC distances of candidates via table gather.

    tables: (Q, M, K) f32; cand_codes: (Q, C, code_bytes) uint8.
    Returns (Q, C) f32.
    """
    q, m, k = tables.shape
    idx = unpack_codes(cand_codes, m, sq_bits)  # (Q, C, M)
    gathered = jnp.take_along_axis(
        tables[:, None, :, :], idx[..., None], axis=3
    )[..., 0]
    return jnp.sum(gathered, axis=-1)


def window_search(
    codes_rows, labels_flat, qtables, rank_tables, *, part, range_codes: int,
    size, r: int, wq: int, window: int, scan: str, saturate: bool = False,
    clamp127: bool = False,
):
    """Window scan of one code range, exact screen, whole-window rerank.

    The flat analog of the grouped IVF path with one partition: range
    `part` holds codes [part*range_codes, (part+1)*range_codes) of
    codes_rows, `size` of them real. Window SELECTION is the exact tile
    screen — a code outside the top-wq windows is beaten by wq better codes,
    so the expanded result is the exact top-r under rank_tables. Also used
    per shard by dist.sharded (codes_rows = the local shard).

    Args:
      codes_rows: (R, 128) uint8 ROW128 storage.
      labels_flat: (R*cpr,) int32 result labels.
      qtables: (Q, M, 16) int8 scan tables.
      rank_tables: (Q, M, 16) float tables to rank the expansion with.
      scan: "triton" | "xla" | "interpret" (index.route).
    """
    q, m, _ = qtables.shape
    gq = min(MAX_GROUP, max(16, 1 << (q - 1).bit_length()))
    gcap = -(-q // gq)
    tabs = jnp.pad(qtables.reshape(q, m * 16), [(0, gcap * gq - q), (0, 0)])
    vals = window_min_scan(
        codes_rows, jnp.full((gcap,), part, jnp.int32),
        jnp.full((gcap,), size, jnp.int32), tabs, code_size=m // 2,
        rows_per_group=range_codes, window=window, mode=scan,
    )
    cv = window_min_to_float(vals[:q], saturate=saturate)   # (Q, C)
    screen_v, sel = exact_tile_screen(cv, wq)
    shape = (q, wq)
    from qadc_tpu.index.ivf import window_rerank

    return window_rerank(
        codes_rows, labels_flat, range_codes,
        rank_tables.reshape(q, 1, m, 16), screen_v,
        jnp.full(shape, part, jnp.int32),
        jnp.broadcast_to(jnp.arange(q, dtype=jnp.int32)[:, None], shape),
        sel, jnp.full(shape, size, jnp.int32), r, window, clamp127=clamp127,
    )


def decode_rows(pq: ProductQuantizer, idx):
    """PQ reconstruction via per-sub-quantizer ROW gathers.

    Args:
      idx: (..., M) int32 centroid indices.

    Returns:
      (..., dim) float32 reconstructions. Unlike quantizers.pq.decode (a
      2-axis fancy gather), this loops the M sub-quantizers and does M
      single-axis embedding-style row gathers.
    """
    parts = [pq.centroids[mm][idx[..., mm]] for mm in range(pq.sq_count)]
    return jnp.concatenate(parts, axis=-1)


@partial(jax.jit, static_argnames=("r",))
def _search_adc_recon(index: FlatIndex, queries, r: int):
    """Wide-K (16-bit) ADC scan as reconstruction GEMM.

    The ADC distance IS the squared distance to the PQ reconstruction
    (table[m][v] = ||res_m - C_m[v]||^2, summed over m), so with K = 65536 the
    scan is: decode codes (M row gathers) -> one GEMM against the query
    batch -> top-r. Replaces both the 65536-entry tables (128 MB+
    per query batch) and the 65536-wide one-hots of the naive formulation.
    Semantics match scan_standard<uint16_t> (query_common.hpp:92-118).
    Chunked over codes; memory is O(chunk * dim), independent of N.
    """
    import math as _math

    pq = index.pq
    rotated = pq.rotate(jnp.asarray(queries, jnp.float32))
    q = rotated.shape[0]
    m = pq.sq_count
    cb = pq.code_size
    cpr = index.cpr
    n_pad = index.n_pad
    chunk = _math.gcd(n_pad, 65536)
    rpc = chunk // cpr                      # storage rows per chunk
    q2 = jnp.sum(rotated * rotated, axis=1)  # (Q,)
    rk = min(r, chunk)

    w = 16                                   # exact-screen window
    g = chunk // w

    def body(i, carry):
        bv, bl = carry
        rows = jax.lax.dynamic_slice_in_dim(index.codes, i * rpc, rpc, axis=0)
        idx = unpack_codes(rows.reshape(chunk, cb), m, 16)     # (chunk, M)
        dec = decode_rows(pq, idx)                             # (chunk, dim)
        d2 = jnp.sum(dec * dec, axis=1)
        cross = jnp.dot(
            rotated, dec.T, precision=jax.lax.Precision.HIGHEST
        )                                                      # (Q, chunk)
        d = q2[:, None] + d2[None, :] - 2.0 * cross
        col = jnp.arange(chunk, dtype=jnp.int32)
        d = jnp.where(col[None, :] + i * chunk < index.n, d, jnp.inf)
        # EXACT top-k via window screening: if code x's window is not among
        # the top-rk windows by min, then rk windows each hold a code better
        # than x, so x is not in the true top-rk. Expanding the winning
        # windows fully therefore contains the exact top-rk; ranking the
        # expansion is exact — and the expensive top_k runs over chunk/W
        # columns instead of chunk. Windows are strided (col = wi + t*g) so
        # the reduce needs no small-minor reshape. When rk >= g (small
        # chunks, e.g. n_pad=1024*odd at r=100) every window wins: skip the
        # screen and rank the whole chunk — top_k(k > g) would crash.
        if rk < g:
            wmin = jnp.min(d.reshape(q, w, g), axis=1)         # (Q, g)
            _, selw = jax.lax.top_k(-wmin, rk)                 # (Q, rk) window ids
            cols = (
                selw[:, :, None]
                + jnp.arange(w, dtype=jnp.int32)[None, None, :] * g
            ).reshape(q, rk * w)
            cv = jnp.take_along_axis(d, cols, axis=1)          # (Q, rk*W)
        else:
            cols = jnp.broadcast_to(col[None, :], (q, chunk))
            cv = d
        cl = jnp.minimum(cols + i * chunk, max(index.n - 1, 0))
        cv2, cl2 = topk_smallest(cv, cl, rk)
        return merge_topk(bv, bl, cv2, cl2, r)

    init = (
        jnp.full((q, r), jnp.inf, jnp.float32),
        jnp.zeros((q, r), jnp.int32),
    )
    return jax.lax.fori_loop(0, n_pad // chunk, body, init)


@partial(jax.jit, static_argnames=("r",))
def search_adc(index: FlatIndex, queries, r: int = 100):
    """Conventional float ADC search: exact top-r of float ADC distances.

    4- and 8-bit codes: chunked one-hot x table scan at Precision.HIGHEST
    (kernels.scan_ref.scan_topk_f32). 16-bit codes use the
    reconstruction-GEMM scan (_search_adc_recon).

    Args:
      queries: (Q, dim) float32.
      r: results per query.

    Returns:
      (dists (Q, r) float32 ascending, labels (Q, r) int32).
    """
    if index.pq.sq_bits == 16:
        return _search_adc_recon(index, queries, r)
    rotated = index.pq.rotate(queries)  # flat assignment = identity residual
    tables = adc_tables(rotated, index.pq.centroids)  # (Q, M, K)
    packed = row128_to_codes(index.codes, index.pq.code_size)
    return scan_topk_f32(
        packed, index.labels, tables, index.pq.sq_bits, r,
        num_valid=index.n,
    )


def _prefix_size(n: int, keep: float) -> int:
    """max(1, n*keep) (reference: db_query_4.cpp:125-126)."""
    return max(1, int(n * keep))


def search_qadc(
    index: FlatIndex, queries, r: int = 100, keep: float = 0.01,
    rerank: bool = True, interpret: bool = False, saturate: bool = False,
    scan_budget_bytes: int | None = None,
):
    """Quick-ADC search (sq_bits must be 4; db_query_4.cpp:393-402).

    keep: fraction of codes float-scanned first to set the int8 bound
      (reference -k flag is in percent; here a plain fraction).
    rerank: float-rerank the int8-screened candidates (2r of them). An
      improvement over the reference: screening stays int8-cheap, but the
      final ranking uses exact float ADC distances, recovering the recall the
      per-entry int8 truncation loses. Costs one tiny gather+matmul per batch.
    saturate: reproduce the reference's saturating int8 accumulation exactly
      (simd_scan.hpp:161): entries are >= 0, so min(sum, 127) equals the
      sequential saturated sum — valid through the window-min too.
    interpret: take the GPU's window route with the scan kernel run in the
      Pallas interpreter (CPU tests only; raises on an accelerator).

    Returns:
      (dists (Q, r) float32, labels (Q, r) int32). Distances are float ADC
      when rerank, quantized-scale otherwise.
    """
    if index.pq.sq_bits != 4:
        raise ValueError("Quick ADC requires sq_bits == 4")
    route = routes.choose(
        "flat_qadc", index, r=r, rerank=rerank, interpret=interpret
    )
    return _search_qadc_impl(
        index, queries, r, keep, rerank, saturate, scan_budget_bytes,
        route.path, route.scan,
    )


@partial(
    jax.jit,
    static_argnames=(
        "r", "keep", "rerank", "saturate", "scan_budget_bytes", "path", "scan"
    ),
)
def _search_qadc_impl(
    index: FlatIndex, queries, r: int, keep: float, rerank: bool,
    saturate: bool, scan_budget_bytes: int | None, path: str, scan: str,
):
    rotated = index.pq.rotate(queries)
    tables = adc_tables(rotated, index.pq.centroids)  # (Q, M, 16)
    cb = index.pq.code_size
    cpr = index.cpr
    n_pad = index.n_pad

    # Keep-prefix float scan -> per-query bound.
    ps = _prefix_size(index.n if index.n else n_pad, keep)
    prefix_rows = -(-ps // cpr)
    prefix = row128_to_codes(index.codes[:prefix_rows], cb)[:ps]
    prefix_d = adc_scan_f32(prefix, tables, 4)  # (Q, ps)
    bound = keep_prefix_bound(prefix_d, r)      # (Q,)

    # QuantizerMAX int8 quantization (per query over that query's tables).
    tables_nn = jnp.maximum(tables, 0.0)
    max_possible = jnp.sum(jnp.max(tables_nn, axis=-1), axis=-1)  # (Q,)
    bound = clamp_bound_to_max_distance(bound, max_possible)
    qmin = jnp.min(tables_nn, axis=(-2, -1))  # (Q,)
    qtables = quantize_tables_int8(
        tables, bound[:, None, None], qmin[:, None, None]
    )

    if path == "window":
        # Window minima select windows; every code of a winning window is
        # ranked. rerank=True ranks with exact f32 tables (recall recovery);
        # False ranks with the quantized tables — EXACT reference-style
        # top-r by quantized distance (top-r windows by min provably contain
        # it). Ranges chunk the code axis when the window-min output would
        # bust the scan budget (per-range exact merges stay exact).
        from qadc_tpu.index.ivf import _default_scan_budget

        window = min(cpr, DEFAULT_WINDOW)
        qp = -(-tables.shape[0] // MAX_GROUP) * MAX_GROUP
        budget = (
            _default_scan_budget() if scan_budget_bytes is None else scan_budget_bytes
        )
        nr = _flat_range_count(n_pad, qp, window, budget)
        range_codes = n_pad // nr
        rank_tables = tables if rerank else qtables.astype(jnp.float32)
        # wq = r suffices under the exact screen when the screen and rank
        # metrics agree (no rerank); with rerank the int8 screen is only an
        # estimate of the float ranking, so keep 2r windows.
        wq = min((2 if rerank else 1) * r, range_codes // window)
        best = None
        for ri in range(nr):
            dv, dl = window_search(
                index.codes, index.labels, qtables, rank_tables, part=ri,
                range_codes=range_codes,
                size=min(max(index.n - ri * range_codes, 0), range_codes),
                r=r, wq=wq, window=window, scan=scan,
                saturate=saturate, clamp127=saturate and not rerank,
            )
            best = (dv, dl) if best is None else merge_topk(*best, dv, dl, r)
        return best

    packed = row128_to_codes(index.codes, cb)
    if not rerank:
        return scan_topk_int8(
            packed, index.labels, qtables, r, num_valid=index.n,
            saturate=saturate,
        )
    rr = min(2 * r, n_pad)
    screen_v, cand = scan_topk_int8(
        packed, index.labels, qtables, rr, num_valid=index.n, saturate=saturate
    )
    # Flat labels are row ids, so candidates gather directly.
    cand_codes = gather_codes_row128(index.codes, cand, cb)   # (Q, rr, cb)
    fd = _exact_rerank(tables, cand_codes, 4)
    # Keep masked (padding) screen entries masked after rerank.
    fd = jnp.where(jnp.isfinite(screen_v), fd, jnp.inf)
    return topk_smallest(fd, cand, r)