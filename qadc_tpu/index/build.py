"""Streaming index builders: linear-time ingest at Deep100M scale.

Reference: index_db::add_vectors appends codes+labels per partition
(databases.hpp:270-298) and flat_db::add_vectors grows one code buffer
(databases.hpp:136-156). The round-1 `ivf.add` instead rebuilt the whole
(P, part_pad) array per chunk — O(chunks * index_size) for a streamed build.

These builders restore the reference's append complexity on the host side:

  - Device does the heavy math per chunk (assign -> residual -> encode).
  - Host buffers grow GEOMETRICALLY (2x) per partition-capacity overflow, so
    total copy work is O(final size).
  - Tail padding (repeat-last-code quirk, simd_layout.hpp:47-50) and the
    ROW128 re-layout happen ONCE at finalize(), not per chunk.

Usage:
    b = IVFBuilder.from_index(index)
    for off, chunk in VectorStream(path):
        b.add(chunk)
    index = b.finalize()
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from qadc_tpu.core.layout import DEFAULT_BLOCK, pad_codes_to_block, to_row128
from qadc_tpu.index.flat import FlatIndex
from qadc_tpu.index.ivf import IVFIndex, PART_ALIGN
from qadc_tpu.ops.knn import assign_nearest
from qadc_tpu.quantizers.pq import encode


def repad_partitions(index: IVFIndex, part_pad: int) -> IVFIndex:
    """Re-pad an IVF index's partitions to a target part_pad.

    Preserves the tail-repeat quirk (repeat last code / clamp label,
    simd_layout.hpp:47-50). part_pad must be a multiple of PART_ALIGN and
    >= max_part_size; used by geometry tests and the multichip dryrun to
    exercise specific block geometries.
    """
    if part_pad % PART_ALIGN != 0:
        raise ValueError(f"part_pad={part_pad} must be a multiple of {PART_ALIGN}")
    if part_pad < index.max_part_size:
        raise ValueError(
            f"part_pad={part_pad} < max_part_size={index.max_part_size}: "
            "re-padding would silently drop real codes"
        )
    p = index.part_count
    cb = index.pq.code_size
    cpr = 128 // cb
    codes = np.asarray(index.codes).reshape(p, -1, cb)
    labels = np.asarray(index.labels)
    sizes = np.asarray(index.part_sizes)
    rows = np.arange(part_pad)[None, :]
    last = np.maximum(sizes, 1)[:, None] - 1
    src = np.minimum(rows, np.minimum(last, codes.shape[1] - 1))
    return IVFIndex(
        pq=index.pq,
        coarse_centroids=index.coarse_centroids,
        codes=jnp.asarray(
            np.take_along_axis(codes, src[:, :, None], axis=1)
            .reshape(p, part_pad // cpr, 128)
        ),
        labels=jnp.asarray(np.take_along_axis(labels, src, axis=1)),
        part_sizes=index.part_sizes,
        n=index.n,
        max_part_size=index.max_part_size,
    )


class FlatBuilder:
    """Accumulate encoded chunks; one concat + re-layout at finalize."""

    def __init__(self, pq, chunks=None, n: int = 0):
        self.pq = pq
        self._chunks: list[np.ndarray] = list(chunks or [])
        self.n = n

    @classmethod
    def from_index(cls, index: FlatIndex) -> "FlatBuilder":
        old = (
            [np.asarray(index.codes).reshape(-1, index.pq.code_size)[: index.n]]
            if index.n
            else []
        )
        return cls(index.pq, old, index.n)

    def add(self, vectors, encode_batch: int = 262144) -> None:
        vectors = np.asarray(vectors, np.float32)
        for s in range(0, vectors.shape[0], encode_batch):
            self._chunks.append(
                np.asarray(encode(self.pq, vectors[s : s + encode_batch]))
            )
        self.n += int(vectors.shape[0])

    def finalize(self) -> FlatIndex:
        cb = self.pq.code_size
        all_codes = (
            np.concatenate(self._chunks, axis=0)
            if self._chunks
            else np.zeros((0, cb), np.uint8)
        )
        return FlatIndex(
            pq=self.pq,
            codes=jnp.asarray(to_row128(pad_codes_to_block(all_codes))),
            n=self.n,
        )


class IVFBuilder:
    """Per-partition append buffers with geometric growth.

    Buffers hold RAW rows only (no tail padding); rows beyond sizes[p] are
    garbage until finalize().
    """

    def __init__(self, pq, coarse_centroids):
        self.pq = pq
        self.coarse = np.asarray(coarse_centroids, np.float32)
        p = self.coarse.shape[0]
        cb = pq.code_size
        self.cap = PART_ALIGN
        self.codes = np.zeros((p, self.cap, cb), np.uint8)
        self.labels = np.zeros((p, self.cap), np.int32)
        self.sizes = np.zeros((p,), np.int64)
        self.n = 0

    @classmethod
    def from_index(cls, index: IVFIndex) -> "IVFBuilder":
        b = cls(index.pq, index.coarse_centroids)
        p = index.part_count
        cb = index.pq.code_size
        sizes = np.asarray(index.part_sizes).astype(np.int64)
        cap = max(PART_ALIGN, 1 << int(np.ceil(np.log2(max(1, sizes.max())))))
        b.cap = int(cap)
        b.codes = np.zeros((p, b.cap, cb), np.uint8)
        b.labels = np.zeros((p, b.cap), np.int32)
        old_codes = np.asarray(index.codes).reshape(p, -1, cb)
        old_labels = np.asarray(index.labels)
        w = min(old_codes.shape[1], b.cap)
        b.codes[:, :w] = old_codes[:, :w]
        b.labels[:, :w] = old_labels[:, :w]
        b.sizes = sizes
        b.n = index.n
        return b

    def _grow(self, need: int) -> None:
        cap = self.cap
        while cap < need:
            cap *= 2
        if cap == self.cap:
            return
        p, _, cb = self.codes.shape
        codes = np.zeros((p, cap, cb), np.uint8)
        labels = np.zeros((p, cap), np.int32)
        codes[:, : self.cap] = self.codes
        labels[:, : self.cap] = self.labels
        self.codes, self.labels, self.cap = codes, labels, cap

    def add(self, vectors, encode_batch: int = 262144) -> None:
        """Assign -> residual -> encode on device; scatter-append on host.

        Only the NEW rows are written (one vectorized scatter per call);
        existing rows are never touched except on geometric growth.
        """
        vectors = np.asarray(vectors, np.float32)
        if vectors.shape[0] == 0:
            return
        coarse_dev = jnp.asarray(self.coarse)
        codes_parts, assign_parts = [], []
        for s in range(0, vectors.shape[0], encode_batch):
            chunk = jnp.asarray(vectors[s : s + encode_batch])
            a = assign_nearest(chunk, coarse_dev)
            res = chunk - coarse_dev[a]
            codes_parts.append(np.asarray(encode(self.pq, res)))
            assign_parts.append(np.asarray(a))
        codes_np = np.concatenate(codes_parts, axis=0)
        assign_np = np.concatenate(assign_parts, axis=0)
        new_labels = np.arange(self.n, self.n + vectors.shape[0], dtype=np.int32)

        p = self.codes.shape[0]
        counts = np.bincount(assign_np, minlength=p).astype(np.int64)
        self._grow(int((self.sizes + counts).max()))
        cap = self.cap
        # Flat destinations: sort by partition, place each run after the
        # partition's existing rows.
        order = np.argsort(assign_np, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(order), dtype=np.int64) - starts[assign_np[order]]
        dest = (
            assign_np[order].astype(np.int64) * cap
            + self.sizes[assign_np[order]]
            + rank
        )
        cb = self.pq.code_size
        self.codes.reshape(-1, cb)[dest] = codes_np[order]
        self.labels.reshape(-1)[dest] = new_labels[order]
        self.sizes += counts
        self.n += int(vectors.shape[0])

    def finalize(self) -> IVFIndex:
        """Tail-pad (repeat last code / clamp label) + ROW128 layout, once."""
        import sys

        p, _, cb = self.codes.shape
        cpr = 128 // cb
        max_size = int(self.sizes.max()) if p else 0
        empty = int((self.sizes == 0).sum()) if p else 0
        if self.n and empty:
            # Reference warns per empty partition at prepare time
            # (db_query_4.cpp:113-117); empty partitions are tolerated (their
            # rows are fully masked) but waste probes.
            print(
                f"warning: {empty}/{p} partitions are empty",
                file=sys.stderr,
            )
        part_pad = max(PART_ALIGN, -(-max(max_size, 1) // PART_ALIGN) * PART_ALIGN)
        rows = np.arange(part_pad, dtype=np.int64)[None, :]
        last = np.maximum(self.sizes, 1)[:, None] - 1
        src = np.minimum(rows, np.minimum(last, self.cap - 1))
        codes3 = np.take_along_axis(self.codes, src[:, :, None], axis=1)
        labels3 = np.take_along_axis(self.labels, src, axis=1)
        return IVFIndex(
            pq=self.pq,
            coarse_centroids=jnp.asarray(self.coarse),
            codes=jnp.asarray(codes3.reshape(p, part_pad // cpr, 128)),
            labels=jnp.asarray(labels3),
            part_sizes=jnp.asarray(self.sizes.astype(np.int32)),
            n=self.n,
            max_part_size=max_size,
        )
