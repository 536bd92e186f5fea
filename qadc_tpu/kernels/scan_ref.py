"""Pure-jnp reference ADC scans (all bit widths, float and int8).

These are the semantic oracles for the scan kernel (kernels/window_scan.py)
and the plain compute path. They use the same one-hot × table product
formulation as the kernel, so parity tests compare like with like:

  distances[Q, B] = tables[Q, M*K] @ OneHot(codes)[B, M*K]^T

Float scan reference: scan_4 / scan_standard (query_common.hpp:59-118).
Int8 scan reference: scan_avx_4 (simd_scan.hpp:125-187) — saturating int8
adds of non-negative entries == min(127, int32 sum).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from qadc_tpu.core.packing import unpack_codes
from qadc_tpu.ops.topk import merge_topk, topk_smallest


def _one_hot_flat(codes_packed, sq_count: int, sq_bits: int, dtype):
    """(B, M*K) one-hot of unpacked code indices."""
    idx = unpack_codes(codes_packed, sq_count, sq_bits)  # (B, M)
    k = 1 << sq_bits
    oh = jax.nn.one_hot(idx, k, dtype=dtype)  # (B, M, K)
    return oh.reshape(idx.shape[0], sq_count * k)


def adc_scan_f32(codes_packed, tables, sq_bits: int):
    """Float ADC scan.

    Args:
      codes_packed: (B, code_bytes) uint8.
      tables: (Q, M, K) float32 per-query lookup tables.
      sq_bits: 4, 8 or 16.

    Returns:
      (Q, B) float32 distances.
    """
    q, m, k = tables.shape
    oh = _one_hot_flat(codes_packed, m, sq_bits, jnp.float32)  # (B, M*K)
    t = tables.reshape(q, m * k)
    return jnp.dot(t, oh.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def adc_scan_int8(codes_packed, qtables, saturate: bool = True):
    """Quick-ADC int8 scan.

    Args:
      codes_packed: (B, code_bytes) uint8 — 4-bit codes.
      qtables: (Q, M, 16) int8 quantized tables (entries in [0, 127]).
      saturate: clamp sums at 127, reproducing the reference's saturating int8
        adds (simd_scan.hpp:161) exactly. The index search paths pass False:
        int32 accumulation is free in a matrix product, and the unsaturated
        sum is strictly more informative (the 127 cap is an AVX artifact).

    Returns:
      (Q, B) int32 distances (in [0, 127] when saturate).
    """
    q, m, k = qtables.shape
    oh = _one_hot_flat(codes_packed, m, 4, jnp.int8)
    t = qtables.reshape(q, m * k)
    acc = jnp.dot(t, oh.T, preferred_element_type=jnp.int32)
    return jnp.minimum(acc, 127) if saturate else acc


def _chunked_scan_topk(
    codes_packed, labels, q: int, r: int, chunk: int, scan_chunk_fn, num_valid=None
):
    """Scan codes in chunks, merging per-chunk top-r (bounded memory).

    scan_chunk_fn: (chunk_codes) -> (Q, C) distances (float32-comparable).
    num_valid: rows >= num_valid are padding and masked to +inf. (The reference
    scans its <=15 padded duplicates per partition — harmless there; at our
    block sizes hundreds of duplicates would flood the top-r, so padding is
    excluded outright.)
    Returns (vals (Q, r), labels (Q, r)).
    """
    n = codes_packed.shape[0]
    n_main = (n // chunk) * chunk
    n_chunks = n_main // chunk
    col = jnp.arange(chunk, dtype=jnp.int32)

    def body(carry, inp):
        best_v, best_l = carry
        c_codes, c_labels, base = inp
        d = scan_chunk_fn(c_codes).astype(jnp.float32)  # (Q, C)
        if num_valid is not None:
            valid = (base + col) < num_valid
            d = jnp.where(valid[None, :], d, jnp.inf)
        lab = jnp.broadcast_to(c_labels[None, :], d.shape)
        cv, cl = topk_smallest(d, lab, min(r, chunk))
        v, l = merge_topk(best_v, best_l, cv, cl, r)
        return (v, l), None

    init = (
        jnp.full((q, r), jnp.inf, jnp.float32),
        jnp.zeros((q, r), jnp.int32),
    )
    codes_r = codes_packed[:n_main].reshape(n_chunks, chunk, codes_packed.shape[1])
    labels_r = labels[:n_main].reshape(n_chunks, chunk)
    row_base = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (vals, labs), _ = jax.lax.scan(body, init, (codes_r, labels_r, row_base))
    if n_main < n:  # tail that chunk does not divide
        tail = n - n_main
        d = scan_chunk_fn(codes_packed[n_main:]).astype(jnp.float32)
        if num_valid is not None:
            valid = (n_main + jnp.arange(tail, dtype=jnp.int32)) < num_valid
            d = jnp.where(valid[None, :], d, jnp.inf)
        lab = jnp.broadcast_to(labels[None, n_main:], d.shape)
        cv, cl = topk_smallest(d, lab, min(r, tail))
        vals, labs = merge_topk(vals, labs, cv, cl, r)
    return vals, labs


@partial(jax.jit, static_argnames=("sq_bits", "r", "chunk", "num_valid"))
def scan_topk_f32(
    codes_packed, labels, tables, sq_bits: int, r: int, chunk: int = 65536,
    num_valid: int | None = None,
):
    """Float ADC scan + exact top-r, chunked over the code axis.

    Args:
      codes_packed: (N_pad, code_bytes) uint8.
      labels: (N_pad,) int32 (padded tail clamped to the last real label).
      tables: (Q, M, K) float32.
      num_valid: real row count; padded rows masked out.

    Returns:
      (vals (Q, r) float32 ascending, labels (Q, r) int32).
    """
    chunk = min(chunk, codes_packed.shape[0])
    return _chunked_scan_topk(
        codes_packed, labels, tables.shape[0], r, chunk,
        lambda c: adc_scan_f32(c, tables, sq_bits),
        num_valid=num_valid,
    )


@partial(jax.jit, static_argnames=("r", "chunk", "num_valid", "saturate"))
def scan_topk_int8(
    codes_packed, labels, qtables, r: int, chunk: int = 65536,
    num_valid: int | None = None, saturate: bool = False,
):
    """Quick-ADC int8 scan + exact top-r, chunked over the code axis.

    Returns (vals (Q, r) float32 of quantized distances, labels (Q, r) int32).
    """
    chunk = min(chunk, codes_packed.shape[0])
    return _chunked_scan_topk(
        codes_packed, labels, qtables.shape[0], r, chunk,
        lambda c: adc_scan_int8(c, qtables, saturate=saturate),
        num_valid=num_valid,
    )
