"""Query→partition routing for the grouped IVF scan.

The reference scans each probed partition once per query (matvec-shaped work,
db_query_4.cpp:287-308) — fine for AVX registers, hostile to tensor cores,
which want many distance columns per pass. Routing inverts the loop, MoE-style:
(query, assignment) pairs are grouped BY PARTITION into groups of up to G
queries; each group scans its partition once with a (codes x G-tables) matmul.

Fully jittable: sort pairs by partition, derive run/group/slot ids with
cumsum tricks, scatter into static-capacity group arrays. Static capacity
bound: every group is either full (G pairs) or the last group of its
partition's run, so n_groups <= min(P, Q*ma) + Q*ma/G.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["group_part", "group_valid", "qa_group", "qa_slot", "n_groups"],
    meta_fields=["group_size", "gcap"],
)
@dataclasses.dataclass(frozen=True)
class RoutedBatch:
    """Routing of (Q, ma) assignments into partition groups.

    Attributes:
      group_part: (gcap,) int32 — partition id scanned by each group (0 for
        unused groups; mask with group_valid).
      group_valid: (gcap,) bool.
      qa_group: (Q, ma) int32 — group holding each (query, assignment) pair.
      qa_slot: (Q, ma) int32 — that pair's column slot within the group.
      n_groups: () int32 — live group count.
      group_size: G (static).
      gcap: static group capacity.
    """

    group_part: jax.Array
    group_valid: jax.Array
    qa_group: jax.Array
    qa_slot: jax.Array
    n_groups: jax.Array
    group_size: int
    gcap: int


def group_capacity(q: int, ma: int, part_count: int, group_size: int) -> int:
    qa = q * ma
    return min(part_count, qa) + -(-qa // group_size)


@partial(jax.jit, static_argnames=("part_count", "group_size"))
def route_queries(parts, part_count: int, group_size: int) -> RoutedBatch:
    """Route (Q, ma) partition assignments into groups.

    Args:
      parts: (Q, ma) int32 partition ids.
      part_count: P (static).
      group_size: G — max queries per group (static).

    Returns:
      RoutedBatch.
    """
    q, ma = parts.shape
    qa = q * ma
    g = group_size
    gcap = group_capacity(q, ma, part_count, g)

    flat_p = parts.reshape(qa)
    order = jnp.argsort(flat_p, stable=True)
    sp = flat_p[order]

    new_run = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sp[1:] != sp[:-1]]
    )
    idx = jnp.arange(qa, dtype=jnp.int32)
    # Start index of each element's run, via running max over run starts.
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(new_run, idx, 0)
    )
    pos = idx - run_start  # position within the partition's run
    new_group = new_run | (pos % g == 0)
    group_id = jnp.cumsum(new_group.astype(jnp.int32)) - 1  # dense ids
    slot = pos % g
    n_groups = group_id[-1] + 1

    group_id_c = jnp.minimum(group_id, gcap - 1)  # safety clamp (bound proof above)
    group_part = (
        jnp.zeros((gcap,), jnp.int32).at[group_id_c].set(sp)
    )
    group_valid = jnp.arange(gcap) < n_groups

    qa_group = jnp.zeros((qa,), jnp.int32).at[order].set(group_id_c).reshape(q, ma)
    qa_slot = jnp.zeros((qa,), jnp.int32).at[order].set(slot).reshape(q, ma)
    return RoutedBatch(
        group_part=group_part,
        group_valid=group_valid,
        qa_group=qa_group,
        qa_slot=qa_slot,
        n_groups=n_groups,
        group_size=g,
        gcap=gcap,
    )
