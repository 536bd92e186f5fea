"""Exact batched k-NN.

Reference: find_k_neighbors (neighbors.cpp:30-76) — 256x256 BLAS tiles pushed
into per-vector binheaps. Here this is one GEMM for the -2*q.b cross terms
plus ||b||^2 (Precision.HIGHEST), followed by lax.top_k; XLA tiles the GEMM
itself so the manual blocking disappears. Used for PQ encoding (k=1 per sub-space),
coarse assignment (k=ma), and k-means assignment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _neg_scores(queries, base):
    """-(||q-b||^2 - ||q||^2) = 2 q.b - ||b||^2 : larger is nearer."""
    b2 = jnp.sum(base * base, axis=-1)  # (N,)
    cross = jnp.dot(
        queries, base.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (Q, N)
    return 2.0 * cross - b2[None, :]


def exact_knn(queries, base, k: int):
    """Exact k nearest neighbors under squared L2.

    Args:
      queries: (Q, dim) float32.
      base: (N, dim) float32.
      k: number of neighbors.

    Returns:
      (dists, idx): (Q, k) float32 true squared distances (ascending) and
      (Q, k) int32 indices.
    """
    queries = jnp.asarray(queries, jnp.float32)
    base = jnp.asarray(base, jnp.float32)
    scores = _neg_scores(queries, base)
    top_scores, idx = jax.lax.top_k(scores, k)
    q2 = jnp.sum(queries * queries, axis=-1, keepdims=True)
    return q2 - top_scores, idx.astype(jnp.int32)


def assign_nearest(vectors, base):
    """Nearest base index per vector (k=1 fast path, no distances).

    Returns (N,) int32.
    """
    vectors = jnp.asarray(vectors, jnp.float32)
    base = jnp.asarray(base, jnp.float32)
    scores = _neg_scores(vectors, base)
    return jnp.argmax(scores, axis=-1).astype(jnp.int32)
