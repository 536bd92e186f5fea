"""Int8 table quantization and keep-prefix bound estimation.

Reproduces the reference's QuantizerMAX semantics bit-for-bit
(db_query_4.cpp:38-71):

  delta = (qmax - qmin) / 127
  q(v)  = 127                      if v >= qmax
        = int((v - qmin) / delta)  otherwise   (trunc toward zero; inputs >= qmin)

with qmin = min over ALL of the query's ma tables, clamped below at 0 with
negative table entries zeroed (db_query_4.cpp:256-269); and qmax = the bound
from the keep-prefix exact scan: the R-th smallest value of {+inf} ∪ {float ADC
distances of the first max(1, size*keep) codes of each probed partition}
(db_query_4.cpp:230-259, heap seeded with one +inf at :232).

The reference uses the bound to prune its scan; here all distances are
computed anyway, so the bound's role is precision: distances at or beyond qmax
saturate to 127 and can never enter the top-R unless the heap is short.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

QMAX_GUARD = 1e30  # reference exits if bound > 1e30 (db_query_4.cpp:271-274)


def clamp_bound_to_max_distance(bound, max_possible):
    """Replace non-finite bounds with the query's maximum possible distance.

    The reference exits when the bound exceeds 1e30 ("Try larger keep value",
    db_query_4.cpp:271-274) — that happens when the keep-prefix holds fewer
    than R codes. Here we degrade gracefully: fall back to the maximum possible
    table sum, so nothing saturates and quantization is merely full-range.
    """
    return jnp.where(
        jnp.isfinite(bound), bound, jnp.asarray(max_possible) * (1.0 + 1e-6)
    )


def quantize_tables_int8(tables, qmax, qmin=None):
    """Quantize float ADC tables to int8 per QuantizerMAX.

    Args:
      tables: (..., M, K) float32 — all tables of one query (e.g. (ma, M, K)),
        or batched with leading query dims if qmax/qmin broadcast accordingly.
      qmax: scalar or broadcastable — per-query quantization upper bound.
      qmin: optional; defaults to max(0, min(tables over all but the leading
        query dims)). Pass explicitly when batching over queries.

    Returns:
      (..., M, K) int8 tables, values in [0, 127].
    """
    tables = jnp.asarray(tables, jnp.float32)
    # Negative entries clamp to 0 (reference db_query_4.cpp:262-269).
    tables = jnp.maximum(tables, 0.0)
    if qmin is None:
        qmin = jnp.maximum(jnp.min(tables), 0.0)
    qmin = jnp.asarray(qmin, jnp.float32)
    qmax = jnp.asarray(qmax, jnp.float32)
    delta = (qmax - qmin) / 127.0
    scaled = (tables - qmin) / jnp.maximum(delta, 1e-30)
    q = jnp.clip(scaled.astype(jnp.int32), 0, 127)
    q = jnp.where(tables >= qmax, 127, q)
    return q.astype(jnp.int8)


def keep_prefix_bound(prefix_dists, r: int, valid_mask=None):
    """Bound = R-th smallest of {+inf} ∪ prefix distances.

    Matches the reference's temp binheap of capacity R seeded with one +inf
    (db_query_4.cpp:230-242): after pushing all prefix distances its max is the
    R-th smallest element of the union.

    Args:
      prefix_dists: (..., P) float32 — float ADC distances of the keep-prefix
        codes (padded entries should be +inf or masked).
      r: heap capacity (result count R).
      valid_mask: optional (..., P) bool; False entries are treated as +inf.

    Returns:
      (...,) float32 bound per query.
    """
    d = jnp.asarray(prefix_dists, jnp.float32)
    if valid_mask is not None:
        d = jnp.where(valid_mask, d, jnp.inf)
    # The +inf seed sorts last among the union's elements, so the R-th smallest
    # of {+inf} ∪ d is simply the R-th smallest of d — and +inf when d has
    # fewer than R entries (then the reference heap is not full and its max is
    # the seed).
    p = d.shape[-1]
    if p < r:
        return jnp.full(d.shape[:-1], jnp.inf, jnp.float32)
    neg_top, _ = jax.lax.top_k(-d, r)  # descending in -d == ascending in d
    return -neg_top[..., r - 1]
