"""Jitted k-means: k-means++ init + Lloyd iterations.

Reference: learn_coarse_quantizer (databases.cpp:94-118) — OpenCV kmeans++
init (2 iterations) then 48 custom Lloyd iterations with OpenMP-parallel
assignment (databases.cpp:50-90). Here both phases are jitted JAX: assignment
is a GEMM+argmax, the update is a segment-sum, and k-means++ is a lax.scan
over D^2-weighted draws with explicit PRNG keys. Distance products run at
Precision.HIGHEST: ||x||^2 - 2 x.c + ||c||^2 cancels, and TF32's ten-bit
mantissa would perturb assignments; training is offline, so the cost is
not on the search path.

The reference divides by zero on empty clusters (databases.cpp:83-88); here
empty clusters keep their previous centroid.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from qadc_tpu.ops.knn import _neg_scores

DEFAULT_ITERS = 50  # reference kmeans_iter_max (databases.cpp:92): 2 cv + 48 Lloyd


@partial(jax.jit, static_argnames=("k",))
def kmeans_plusplus_init(key, x, k: int):
    """k-means++ seeding.

    Args:
      key: PRNG key.
      x: (N, dim) float32 data.
      k: number of centroids.

    Returns:
      (k, dim) float32 initial centroids.
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    key0, key_scan = jax.random.split(key)
    first = x[jax.random.randint(key0, (), 0, n)]

    x2 = jnp.sum(x * x, axis=-1)

    def sqdist_to(c):
        xc = jnp.dot(x, c, precision=jax.lax.Precision.HIGHEST)
        return jnp.maximum(x2 - 2.0 * xc + jnp.sum(c * c), 0.0)

    def step(carry, key_i):
        min_d2 = carry
        # Sample proportional to D^2 (fall back to uniform if all-zero).
        total = jnp.sum(min_d2)
        probs = jnp.where(total > 0, min_d2 / jnp.maximum(total, 1e-30), 1.0 / n)
        idx = jax.random.categorical(key_i, jnp.log(probs + 1e-30))
        c = x[idx]
        min_d2 = jnp.minimum(min_d2, sqdist_to(c))
        return min_d2, c

    keys = jax.random.split(key_scan, k - 1)
    _, rest = jax.lax.scan(step, sqdist_to(first), keys)
    return jnp.concatenate([first[None], rest], axis=0)


@partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(key, x, k: int, iters: int = DEFAULT_ITERS):
    """Full k-means.

    Args:
      key: PRNG key (init).
      x: (N, dim) float32.
      k: centroid count.
      iters: Lloyd iterations.

    Returns:
      (centroids (k, dim) float32, assignments (N,) int32).
    """
    x = jnp.asarray(x, jnp.float32)
    centroids = kmeans_plusplus_init(key, x, k)

    def lloyd(centroids, _):
        assign = jnp.argmax(_neg_scores(x, centroids), axis=-1)
        counts = jnp.zeros((k,), jnp.float32).at[assign].add(1.0)
        sums = jnp.zeros_like(centroids).at[assign].add(x)
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        # Empty clusters keep the previous centroid (reference bug fixed).
        new = jnp.where(counts[:, None] > 0, new, centroids)
        return new, None

    centroids, _ = jax.lax.scan(lloyd, centroids, None, length=iters)
    assign = jnp.argmax(_neg_scores(x, centroids), axis=-1).astype(jnp.int32)
    return centroids, assign


@jax.jit
def median_split(key, xs):
    """Split points into two BALANCED halves: median cut on the principal axis.

    Vanilla 2-means minimizes SSE, not balance — on a dense ball plus a
    satellite it splits off the satellite and leaves the ball whole
    (measured: balance_centroids oscillated without capping). The median
    cut guarantees each side holds <= ceil(S/2) points, so repeated splits
    provably shrink the largest cell.

    Args:
      key: PRNG key (power-iteration init).
      xs: (S, dim) float32 points.

    Returns:
      (2, dim) float32 — means of the two halves.
    """
    xs = jnp.asarray(xs, jnp.float32)
    mu = xs.mean(axis=0)
    xc = xs - mu
    cov_mul = lambda v: xc.T @ (xc @ v)  # noqa: E731 — (dim,) matvec
    v = jax.random.normal(key, (xs.shape[1],), jnp.float32)

    def power(v, _):
        w = cov_mul(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30), None

    v, _ = jax.lax.scan(power, v, None, length=8)
    t = xc @ v
    med = jnp.median(t)
    left = t <= med
    c1 = jnp.where(left[:, None], xs, 0.0).sum(0) / jnp.maximum(
        left.sum(), 1
    )
    c2 = jnp.where(left[:, None], 0.0, xs).sum(0) / jnp.maximum(
        (~left).sum(), 1
    )
    return jnp.stack([c1, c2])


@partial(jax.jit, static_argnames=("iters",))
def lloyd_refine(x, centroids, iters: int = 2):
    """Lloyd iterations from GIVEN centroids (no re-init).

    Same update rule as kmeans() (empty clusters keep their previous
    centroid); used by balance_centroids to settle after a split.
    """
    x = jnp.asarray(x, jnp.float32)
    k = centroids.shape[0]

    def step(c, _):
        assign = jnp.argmax(_neg_scores(x, c), axis=-1)
        counts = jnp.zeros((k,), jnp.float32).at[assign].add(1.0)
        sums = jnp.zeros_like(c).at[assign].add(x)
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where(counts[:, None] > 0, new, c), None

    out, _ = jax.lax.scan(step, jnp.asarray(centroids, jnp.float32), None,
                          length=iters)
    return out


def balance_centroids(key, x, centroids, cap_ratio: float = 3.0,
                      max_rounds: int = 64, settle_iters: int = 0,
                      split_sample: int = 8192):
    """Bound the largest cell at cap_ratio x the mean, keeping K fixed.

    Static shapes pad every IVF partition to the LARGEST one
    (index/build.py finalize), so one mega-cell inflates storage, scan
    output width, and screen cost for the whole index (the clustered
    SIFT-moment generator at 1M makes cells of 20x the mean). The reference
    never faces this (variable-length partition vectors, databases.hpp:
    176-331); bounding cell size at BUILD time is the static-shape answer,
    and finer cells where data is dense also helps recall.

    Each round: assign x; if the largest cell <= cap, done. Otherwise
    split the largest cell with a principal-axis MEDIAN cut (median_split
    — balanced by construction, where 2-means would shave off a satellite
    and oscillate) on a fixed-size member subsample (fixed so the jitted
    split compiles once) into two centroids, one of which replaces the
    smallest cell's centroid (K unchanged; the retired cell's members fall
    to their next-nearest neighbors). settle_iters Lloyd iterations after
    each split default to 0: Lloyd re-converges toward the SSE optimum,
    which IS the skewed solution — measured, 2 settle iterations undid
    every split (max cell 2000 pre-settle -> 3400 post-settle) and the
    loop never capped. Host-side loop: build-time only.

    Returns (centroids, assignments of x).
    """
    import numpy as np

    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    k = centroids.shape[0]
    cap = max(1, int(cap_ratio * n / k))
    cent = jnp.asarray(centroids, jnp.float32)
    assign = np.asarray(jnp.argmax(_neg_scores(x, cent), axis=-1))
    x_np = None
    for _ in range(max_rounds):
        counts = np.bincount(assign, minlength=k)
        big = int(counts.argmax())
        if counts[big] <= cap:
            break
        small = int(counts.argmin())
        if small == big:  # k == 1 degenerate
            break
        if x_np is None:
            x_np = np.asarray(x)
        members = np.flatnonzero(assign == big)
        key, k_pick, k_seed = jax.random.split(key, 3)
        if members.size > split_sample:
            pick = np.asarray(
                jax.random.choice(k_pick, members.size, (split_sample,),
                                  replace=False)
            )
            members = members[pick]
        else:  # pad by cycling members: fixed shape, uniform duplication
            members = members[
                np.arange(split_sample) % max(1, members.size)
            ]
        two = median_split(k_seed, x_np[members])
        cent = cent.at[big].set(two[0]).at[small].set(two[1])
        if settle_iters:
            cent = lloyd_refine(x, cent, iters=settle_iters)
        assign = np.asarray(jnp.argmax(_neg_scores(x, cent), axis=-1))
    return cent, jnp.asarray(assign, jnp.int32)
