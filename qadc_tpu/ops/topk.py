"""Data-parallel top-k building blocks.

The reference's bound-pruned binheap (binheap.hpp:75-116) is inherently serial;
here top-k becomes: (1) a windowed min-reduction that shrinks N candidates to
N/W per query, (2) an exact screen of the window minima whose winners are
expanded and ranked exactly, and for sharded scans (3) a merge of per-shard
(value, label) pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def window_min_reduce(dists, window: int, base_index: int = 0):
    """Per-window min + argmin along the leading (code) axis.

    Args:
      dists: (N, Q) distances (any dtype with ordering).
      window: W, must divide N.
      base_index: offset added to returned indices (global code offset).

    Returns:
      (vals (N//W, Q), idx (N//W, Q) int32) — per window, the min distance and
      the GLOBAL index of its code.
    """
    n, q = dists.shape
    if n % window != 0:
        raise ValueError(f"window {window} must divide N={n}")
    g = n // window
    shaped = dists.reshape(g, window, q)
    vals = jnp.min(shaped, axis=1)
    arg = jnp.argmin(shaped, axis=1).astype(jnp.int32)
    row_base = jnp.arange(g, dtype=jnp.int32)[:, None] * window + base_index
    return vals, arg + row_base


# Rows at or below this width go through a full stable sort instead of
# lax.top_k. Ties break by position (stable sort), matching lax.top_k's
# lower-index-first order. Untuned on the H100 (ROADMAP).
SORT_TOPK_MAX_C = 1024


def topk_smallest(dists, labels, k: int):
    """Top-k smallest along the LAST axis, carrying labels. Exact.

    Rows of at most SORT_TOPK_MAX_C elements go through a stable variadic
    sort, wider rows through lax.top_k.

    Args:
      dists: (..., C) distances.
      labels: (..., C) int32 labels aligned with dists.
      k: result count.

    Returns:
      (vals (..., k) ascending, labels (..., k) int32).
    """
    d = jnp.asarray(dists, jnp.float32)
    c = d.shape[-1]
    if c <= max(SORT_TOPK_MAX_C, k):
        sv, sl = jax.lax.sort(
            (d, jnp.asarray(labels)), dimension=-1, num_keys=1, is_stable=True
        )
        return sv[..., :k], sl[..., :k]
    top, idx = jax.lax.top_k(-d, k)
    return -top, jnp.take_along_axis(labels, idx, axis=-1)


def exact_screen_smallest(vals, k: int, idx=None):
    """EXACT k-smallest + argmin indices along the last axis, sort-cascade.

    Keeps the per-chunk top-k via stable variadic sorts (chunks of
    SORT_TOPK_MAX_C) and recurses on the per-chunk survivors: exact because
    a global top-k member is a top-k member of its chunk. Ties break by
    lower index (stable sorts over index-ordered chunks), matching
    lax.top_k.

    idx: optional (..., C) int32 CUSTOM payload returned in place of the
    positional indices (the cascade carries one int32 payload either way, so
    a caller-supplied column id rides free of a post-sort gather).

    Returns (vals (..., k) ascending, idx (..., k) int32).
    """
    lead = vals.shape[:-1]
    w = vals.shape[-1]
    v = jnp.asarray(vals, jnp.float32).reshape(-1, w)
    q = v.shape[0]
    if idx is None:
        idx = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32), (q, w))
    else:
        idx = jnp.asarray(idx, jnp.int32).reshape(-1, w)
        idx = jnp.broadcast_to(idx, (q, w))
    c = max(SORT_TOPK_MAX_C, k)
    while v.shape[1] > c:
        w = v.shape[1]
        s = -(-w // c)
        kk = min(k, c)
        if s * kk >= w:  # chunking would not shrink: final sort handles it
            break
        if s * c != w:
            v = jnp.pad(v, [(0, 0), (0, s * c - w)], constant_values=jnp.inf)
            idx = jnp.pad(idx, [(0, 0), (0, s * c - w)])
        v = v.reshape(q * s, c)
        idx = idx.reshape(q * s, c)
        v, idx = jax.lax.sort((v, idx), dimension=-1, num_keys=1, is_stable=True)
        v = v[:, :kk].reshape(q, s * kk)
        idx = idx[:, :kk].reshape(q, s * kk)
    v, idx = jax.lax.sort((v, idx), dimension=-1, num_keys=1, is_stable=True)
    return v[:, :k].reshape(*lead, k), idx[:, :k].reshape(*lead, k)


def _screen_topk_enabled() -> bool:
    """A/B switch: run exact_tile_screen's two exact selections through
    lax.top_k instead of the sort cascade. Read at TRACE time (A/B harnesses
    must jax.clear_caches() between flips). Default OFF; which is faster on
    the H100 is not measured (ROADMAP).
    """
    import os

    return os.environ.get("QADC_SCREEN_TOPK", "0") != "0"


def exact_tile_screen(vals, k: int, tile: int = 32, mins=None):
    """EXACT k-smallest + indices along the last axis, via tile minima.

    Same contract as exact_screen_smallest, at a fraction of the sort
    volume: reduce the row to N/tile tile-minima (one cheap reduce),
    exactly screen THOSE, row-gather the winning tiles' members (contiguous
    tile-f32 slices — near-bandwidth, unlike element gathers), and exactly
    screen the k*tile members. The result is the top-k by (value, column):
    ties resolve to the lower column, as lax.top_k resolves them.
    Containment is provable: if a top-k element's tile missed the tile cut,
    k tiles precede it by (tile min, tile id), and each holds an element
    that precedes it by (value, column) — contradiction.

    mins: optional (..., w // tile) PRECOMPUTED tile minima; skips the
    min-reduce over the full row. Must equal jnp.min over each contiguous
    tile; w % tile must be 0.
    """
    w = vals.shape[-1]
    if w <= max(4 * tile, k * 2 * tile, SORT_TOPK_MAX_C) and mins is None:
        return exact_screen_smallest(vals, k)  # tiling would not shrink
    lead = vals.shape[:-1]
    v = jnp.asarray(vals, jnp.float32).reshape(-1, w)
    pad = (-w) % tile
    if pad:
        if mins is not None:
            raise ValueError(f"precomputed mins require tile | width, got "
                             f"width={w} tile={tile}")
        v = jnp.pad(v, [(0, 0), (0, pad)], constant_values=jnp.inf)
    q, wp = v.shape
    ntiles = wp // tile
    dm = v.reshape(q, ntiles, tile)
    if mins is not None:
        if mins.shape[-1] != ntiles:
            raise ValueError(
                f"mins minor dim {mins.shape[-1]} != width//tile {ntiles}"
            )
        mins = jnp.asarray(mins, jnp.float32).reshape(q, ntiles)
    else:
        mins = jnp.min(dm, axis=-1)                        # (Q, ntiles)
    kt = min(k, ntiles)
    if _screen_topk_enabled():
        # TopK-custom-call variant (same exact selection, lower-index-first
        # ties like the stable cascade): one top_k for the tile cut, one for
        # the members, payload columns gathered after.
        _, ti = jax.lax.top_k(-mins, kt)
        ti = jax.lax.sort(ti, dimension=-1)                # ascending tile ids
        cand = jnp.take_along_axis(dm, ti[..., None], axis=1)
        cidx = ti[..., None] * tile + jnp.arange(tile, dtype=jnp.int32)
        nsv, mi = jax.lax.top_k(-cand.reshape(q, kt * tile), min(k, kt * tile))
        sv = -nsv
        idx = jnp.take_along_axis(cidx.reshape(q, kt * tile), mi, axis=-1)
    else:
        inner = exact_tile_screen if ntiles > 16384 else exact_screen_smallest
        _, ti = inner(mins, kt)                            # exact tile cut
        # Ascending tile ids put the members in column order, so the stable
        # cascade breaks value ties by lower column: the result is the
        # top-k by (value, column), independent of how the row is tiled.
        ti = jnp.sort(ti, axis=-1)
        cand = jnp.take_along_axis(dm, ti[..., None], axis=1)  # (Q, kt, tile)
        # Members carry their GLOBAL column as the sort payload — no
        # post-sort take_along_axis gather (the cascade carries one int32
        # payload either way).
        cidx = ti[..., None] * tile + jnp.arange(tile, dtype=jnp.int32)
        sv, idx = exact_screen_smallest(
            cand.reshape(q, kt * tile), min(k, kt * tile),
            idx=cidx.reshape(q, kt * tile),
        )
    kk = sv.shape[-1]
    if kk < k:  # row narrower than k after the tile cut: pad the contract
        sv = jnp.pad(sv, [(0, 0), (0, k - kk)], constant_values=jnp.inf)
        idx = jnp.pad(idx, [(0, 0), (0, k - kk)])
    return sv.reshape(*lead, k), idx.reshape(*lead, k)


def merge_topk(vals_a, labels_a, vals_b, labels_b, k: int):
    """Merge two per-query candidate sets into the k smallest."""
    vals = jnp.concatenate([vals_a, vals_b], axis=-1)
    labels = jnp.concatenate([labels_a, labels_b], axis=-1)
    return topk_smallest(vals, labels, k)
