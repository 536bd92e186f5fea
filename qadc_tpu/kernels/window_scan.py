"""Window-minimum ADC scans: the Quick-ADC hot loop.

Reference hot loop: scan_avx_4 (simd_scan.hpp:125-187) — per 16 codes, two
pshufb LUT lookups per code byte, saturating int8 adds, bound-compare, heap.

Here the 16-entry lookup becomes a one-hot x table product that serves a
whole group of queries per pass over the codes, and the bound-pruned heap
becomes a window minimum that the caller screens and expands:

    acc[G, N]  = tables[G, M*16] @ OneHot(codes)[N, M*16]^T   (int8 -> int32)
    vals[G, w] = min(acc[:, w*W : (w+1)*W])

Windows are W CONSECUTIVE codes of one partition. With W equal to the codes
per 128-byte storage row (core/layout.py) a window is exactly one storage
row, so the rerank (index.ivf.window_rerank) gathers one row per window.

Queries are grouped by partition (index/routing.py): group g scans partition
group_part[g] against its G query tables, and the output row g*G + s holds
slot s's window minima. Windows that start at or past the partition's real
size hold the sentinel (int32 max, or +inf for float tables), so callers need
no separate validity mask.

Two implementations return identical values:
  - the Pallas kernel through Triton (`mode="triton"`, or `"interpret"` to
    run the same kernel in the Pallas interpreter on the CPU). Each program
    loads its group's partition id and size itself, skips blocks past the
    partition's size, builds the nibble one-hot in registers, runs an int8
    tensor-core product with int32 accumulation and writes only window
    minima — the (G, N) distance block never reaches device memory;
  - plain XLA (`mode="xla"`): gather, one-hot, batched product, min. It also
    takes float32 tables (conventional ADC, at Precision.HIGHEST) and 8-bit
    codes.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from qadc_tpu.core.packing import unpack_codes

DEFAULT_WINDOW = 16
DEFAULT_BLOCK_N = 1024   # codes per kernel program
DOT_N = 128              # codes per tensor-core product inside a program
SENTINEL_I32 = int(np.iinfo(np.int32).max)

# Transient budget for one step of the plain XLA scan (one-hot + products).
_XLA_STEP_BYTES = 1 << 30


def _sentinel(dtype):
    return SENTINEL_I32 if jnp.issubdtype(dtype, jnp.integer) else jnp.inf


def _scan_kernel(gpart_ref, gsize_ref, codes_ref, tab_ref, out_ref, *,
                 rows_per_group: int, block_n: int, dot_n: int, window: int,
                 code_size: int):
    """One program: group program_id(0), codes block program_id(1)."""
    gi = pl.program_id(0)
    bi = pl.program_id(1)
    part = gpart_ref[gi]
    size = gsize_ref[gi]
    tables = tab_ref[...]                                  # (G, cb*32) int8
    g = tables.shape[0]
    nw = dot_n // window

    def step(s, carry):
        start = bi * block_n + s * dot_n                   # partition-local
        cols = pl.ds((s * dot_n) // window, nw)

        @pl.when(start < size)
        def _():
            x = codes_ref[pl.ds(part * rows_per_group + start, dot_n), :]
            x = x.astype(jnp.int32)                        # (dot_n, cb)
            # One-hot column l = byte b*32 + nibble h*16 + centroid j, which
            # is sub-quantizer 2b+h (pack_codes: even sq in the low nibble).
            lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 32), 2)
            nib = (x[:, :, None] >> jnp.where(lane >= 16, 4, 0)) & 15
            oh = (nib == (lane & 15)).astype(jnp.int8)
            oh = oh.reshape(dot_n, code_size * 32)
            acc = jax.lax.dot_general(
                tables, oh, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )                                              # (G, dot_n)
            wmin = jnp.min(acc.reshape(g, nw, window), axis=2)
            wstart = start + jax.lax.broadcasted_iota(jnp.int32, (1, nw), 1) * window
            out_ref[:, cols] = jnp.where(wstart < size, wmin, SENTINEL_I32)

        @pl.when(start >= size)
        def _():
            out_ref[:, cols] = jnp.full((g, nw), SENTINEL_I32, jnp.int32)

        return carry

    jax.lax.fori_loop(0, block_n // dot_n, step, 0)


def _scan_pallas(codes, group_part, group_sizes, tables, *, rows_per_group,
                 window, block_n, interpret):
    n, cb = codes.shape
    gcap = group_part.shape[0]
    g = tables.shape[0] // gcap
    dot_n = min(DOT_N, block_n)
    if g < 16 or g & (g - 1):
        raise ValueError(f"group width {g} must be a power of two >= 16")
    if dot_n % window or block_n % dot_n or rows_per_group % block_n:
        raise ValueError(
            f"window {window} | {dot_n} | block_n {block_n} | "
            f"rows_per_group {rows_per_group} must each divide the next"
        )
    kernel = functools.partial(
        _scan_kernel, rows_per_group=rows_per_group, block_n=block_n,
        dot_n=dot_n, window=window, code_size=cb,
    )
    return pl.pallas_call(
        kernel,
        grid=(gcap, rows_per_group // block_n),
        in_specs=[
            pl.BlockSpec((gcap,), lambda i, j: (0,)),
            pl.BlockSpec((gcap,), lambda i, j: (0,)),
            pl.BlockSpec((n, cb), lambda i, j: (0, 0)),
            pl.BlockSpec((g, cb * 32), lambda i, j: (i, 0)),
        ],
        out_specs=pl.BlockSpec((g, block_n // window), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct(
            (gcap * g, rows_per_group // window), jnp.int32
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="qadc_window_scan",
    )(group_part, group_sizes, codes, tables)


def _scan_xla(codes, group_part, group_sizes, tables, *, rows_per_group,
              window, sq_bits):
    """Plain-XLA twin of the kernel (any table dtype, 4- or 8-bit codes)."""
    n, cb = codes.shape
    gcap = group_part.shape[0]
    g = tables.shape[0] // gcap
    m = cb * 8 // sq_bits
    lanes = m << sq_bits
    chunk = math.gcd(rows_per_group, 8192)
    nchunk = rows_per_group // chunk
    tab3 = tables.reshape(gcap, g, lanes)
    precision = (
        None if jnp.issubdtype(tables.dtype, jnp.integer)
        else jax.lax.Precision.HIGHEST
    )
    oh_dtype = jnp.int8 if precision is None else tables.dtype
    acc_dtype = jnp.int32 if precision is None else jnp.float32

    def one(item):
        gi, ci = item
        start = group_part[gi] * rows_per_group + ci * chunk
        c = jax.lax.dynamic_slice_in_dim(codes, start, chunk)
        idx = unpack_codes(c, m, sq_bits)                  # (chunk, M)
        oh = jax.nn.one_hot(idx, 1 << sq_bits, dtype=oh_dtype)
        acc = jnp.dot(
            tab3[gi], oh.reshape(chunk, lanes).T,
            preferred_element_type=acc_dtype, precision=precision,
        )                                                  # (G, chunk)
        wmin = jnp.min(acc.reshape(g, chunk // window, window), axis=2)
        wstart = ci * chunk + jnp.arange(chunk // window) * window
        return jnp.where(wstart[None, :] < group_sizes[gi], wmin,
                         _sentinel(acc_dtype))

    item_bytes = chunk * lanes * jnp.dtype(oh_dtype).itemsize + g * chunk * 4
    batch = max(1, min(gcap * nchunk, _XLA_STEP_BYTES // item_bytes))
    gi, ci = jnp.divmod(jnp.arange(gcap * nchunk, dtype=jnp.int32), nchunk)
    out = jax.lax.map(one, (gi, ci), batch_size=batch)  # (gcap*nchunk, G, cw)
    out = out.reshape(gcap, nchunk, g, chunk // window).transpose(0, 2, 1, 3)
    return out.reshape(gcap * g, rows_per_group // window)


@functools.partial(
    jax.jit,
    static_argnames=("code_size", "rows_per_group", "window", "mode",
                     "block_n", "sq_bits"),
)
def window_min_scan(
    codes_rows, group_part, group_sizes, tables, *, code_size: int,
    rows_per_group: int, window: int, mode: str,
    block_n: int = DEFAULT_BLOCK_N, sq_bits: int = 4,
):
    """Per-slot window minima of every group's partition.

    Args:
      codes_rows: (R, 128) uint8 row128 storage; partition p holds codes
        [p*rows_per_group, (p+1)*rows_per_group).
      group_part: (GCAP,) int32 partition scanned by each group.
      group_sizes: (GCAP,) int32 real codes in that partition (0 skips the
        group).
      tables: (GCAP*G, M*K) per-slot tables, column m*K + centroid; int8
        for Quick ADC, float32 for conventional ADC (mode "xla" only).
      mode: "triton" (compiled kernel), "interpret" (the same kernel in the
        Pallas interpreter) or "xla" (plain XLA). index.route chooses it.
      block_n: codes per kernel program (kernel modes).

    Returns:
      (GCAP*G, rows_per_group // window) window minima, int32 for int8
      tables and float32 for float tables; windows starting at or past the
      partition's size hold the sentinel (SENTINEL_I32 or +inf).
    """
    codes = codes_rows.reshape(-1, code_size)
    group_part = jnp.asarray(group_part, jnp.int32)
    group_sizes = jnp.asarray(group_sizes, jnp.int32)
    if mode == "xla":
        return _scan_xla(
            codes, group_part, group_sizes, tables,
            rows_per_group=rows_per_group, window=window, sq_bits=sq_bits,
        )
    if mode not in ("triton", "interpret"):
        raise ValueError(f"unknown scan mode {mode!r}")
    if sq_bits != 4 or tables.dtype != jnp.int8:
        raise ValueError("the scan kernel takes 4-bit codes and int8 tables")
    return _scan_pallas(
        codes, group_part, group_sizes, tables,
        rows_per_group=rows_per_group, window=window,
        block_n=math.gcd(block_n, rows_per_group),
        interpret=mode == "interpret",
    )


def window_min_to_float(vals, saturate: bool = False):
    """Window minima as float32 with the sentinel mapped to +inf.

    saturate: clamp at 127 — entries are >= 0, so the window minimum of the
    reference's saturating int8 sums (simd_scan.hpp:161) is min(min, 127).
    """
    v = vals.astype(jnp.float32)
    if saturate:
        v = jnp.minimum(v, 127.0)
    if jnp.issubdtype(vals.dtype, jnp.integer):
        v = jnp.where(vals == SENTINEL_I32, jnp.inf, v)
    return v
