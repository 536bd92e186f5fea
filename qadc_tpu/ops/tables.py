"""ADC distance-table computation.

The per-query lookup table dists[m, k] = ||r_m - c_{m,k}||^2 where r_m is the
m-th sub-vector of the (residual) query and c_{m,k} the k-th centroid of
sub-quantizer m.

Reference: compute_dists_single_simd_cg / compute_cross_dists_blas
(distances.hpp:152-183, 294-311) — an AVX-FMA path for single queries and a
BLAS sgemm ||a||^2+||b||^2-2ab path for batches, template-dispatched over
sub-vector dimension (distances.cpp:15-121). Here there is one jitted
einsum: XLA specializes per shape, a GEMM does the cross terms, and the same
code serves batch size 1 and 10k.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def adc_tables(residuals, centroids):
    """Compute ADC lookup tables.

    Args:
      residuals: (..., dim) float32 — (rotated) residual queries. Any number of
        leading batch dims (e.g. (Q, ma, dim)).
      centroids: (M, K, dsq) float32 PQ codebooks, dim = M * dsq.

    Returns:
      (..., M, K) float32 squared-distance tables.
    """
    residuals = jnp.asarray(residuals, jnp.float32)
    centroids = jnp.asarray(centroids, jnp.float32)
    m, k, dsq = centroids.shape
    batch_shape = residuals.shape[:-1]
    r = residuals.reshape(*batch_shape, m, dsq)
    r2 = jnp.sum(r * r, axis=-1)                      # (..., M)
    c2 = jnp.sum(centroids * centroids, axis=-1)      # (M, K)
    cross = jnp.einsum(
        "...md,mkd->...mk", r, centroids,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return r2[..., None] + c2 - 2.0 * cross
