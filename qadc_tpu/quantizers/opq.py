"""Optimized Product Quantizer: PQ + learned orthonormal rotation.

Reference: opq (quantizers.hpp:248-324). The rotation is applied to vectors
before encoding and to residuals before table computation, as one batched
matmul: rotated = X @ R^T (cblas_sgemm NoTrans/Trans, quantizers.hpp:289-301).
The reference's single-vector rotate is dead code poisoned with assert(false)
(quantizers.hpp:279-287) — here there is only the batched path.

Training (external in the reference) is in-framework: OPQ-NP alternating
minimization (Ge et al., CVPR'13): fix R, refresh the PQ on rotated data; fix
the PQ, update R by orthogonal Procrustes (SVD of X^T @ decode(codes)).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from qadc_tpu.quantizers.pq import ProductQuantizer, encode_indices, train_pq
from qadc_tpu.ops.knn import _neg_scores


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["centroids", "rotation"],
    meta_fields=["sq_bits"],
)
@dataclasses.dataclass(frozen=True)
class OPQQuantizer(ProductQuantizer):
    """PQ with a (dim, dim) rotation R; rotate(x) = x @ R^T."""

    rotation: jax.Array = None

    def validate(self) -> "OPQQuantizer":
        super().validate()
        d = self.dim
        if self.rotation.shape != (d, d):
            raise ValueError(f"rotation shape {self.rotation.shape} != ({d},{d})")
        return self

    def rotate(self, vectors):
        return jnp.dot(
            jnp.asarray(vectors, jnp.float32),
            self.rotation.T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def unrotate(self, vectors):
        return jnp.dot(
            jnp.asarray(vectors, jnp.float32),
            self.rotation,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )


def train_opq(
    key,
    x,
    sq_count: int,
    sq_bits: int,
    opq_iters: int = 20,
    kmeans_iters: int = 25,
    init_rotation=None,
):
    """Train an OPQ by alternating minimization.

    Args:
      key: PRNG key.
      x: (N, dim) float32 training vectors.
      sq_count, sq_bits: PQ geometry.
      opq_iters: outer alternations.
      kmeans_iters: Lloyd iterations per centroid refresh.
      init_rotation: optional (dim, dim) initial rotation (default identity).

    Returns:
      OPQQuantizer.
    """
    x = jnp.asarray(x, jnp.float32)
    n, dim = x.shape
    if init_rotation is None:
        rotation = jnp.eye(dim, dtype=jnp.float32)
    else:
        rotation = jnp.asarray(init_rotation, jnp.float32)

    key_pq, key_iters = jax.random.split(key)
    pq = train_pq(
        key_pq,
        jnp.dot(x, rotation.T, precision=jax.lax.Precision.HIGHEST),
        sq_count, sq_bits, iters=kmeans_iters,
    )

    k = 1 << sq_bits
    dsq = dim // sq_count

    def lloyd_refresh(centroids_m, xs):
        """Warm-started Lloyd steps for one sub-space: (K, dsq), (N, dsq)."""
        def step(c, _):
            assign = jnp.argmax(_neg_scores(xs, c), axis=-1)
            counts = jnp.zeros((k,), jnp.float32).at[assign].add(1.0)
            sums = jnp.zeros_like(c).at[assign].add(xs)
            new = sums / jnp.maximum(counts, 1.0)[:, None]
            return jnp.where(counts[:, None] > 0, new, c), None

        out, _ = jax.lax.scan(step, centroids_m, None, length=kmeans_iters)
        return out

    # x is a jit ARGUMENT, not a closure: closed-over arrays embed as HLO
    # constants in the compiled program — a 100k x 960-d GIST learn set
    # (384 MB) would bloat the program and the compile cache.
    @jax.jit
    def alternate(x, rotation, centroids):
        xr = jnp.dot(x, rotation.T, precision=jax.lax.Precision.HIGHEST)
        # (1) Nearest-centroid assignment under current R (encode in rotated space).
        base = ProductQuantizer(centroids=centroids, sq_bits=sq_bits)
        idx = encode_indices(base, xr)                                # (N, M)
        recon = centroids[jnp.arange(sq_count)[None, :], idx]         # (N, M, dsq)
        y = recon.reshape(n, dim)
        # (2) Procrustes: min_R ||X R^T - Y||_F  =>  R^T = U V^T, X^T Y = U S V^T.
        u, _, vt = jnp.linalg.svd(
            jnp.dot(x.T, y, precision=jax.lax.Precision.HIGHEST),
            full_matrices=False,
        )
        new_rotation = jnp.dot(u, vt, precision=jax.lax.Precision.HIGHEST).T
        # (3) Warm-started Lloyd refresh of each sub-space codebook.
        xr2 = jnp.dot(
            x, new_rotation.T, precision=jax.lax.Precision.HIGHEST
        ).reshape(n, sq_count, dsq).transpose(1, 0, 2)
        new_centroids = jax.vmap(lloyd_refresh)(centroids, xr2)
        return new_rotation, new_centroids

    del key_iters
    centroids = pq.centroids
    for _ in range(opq_iters):
        rotation, centroids = alternate(x, rotation, centroids)

    return OPQQuantizer(
        centroids=centroids, sq_bits=sq_bits, rotation=rotation
    ).validate()
