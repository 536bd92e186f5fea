"""Index checkpoint format: npz arrays + JSON manifest.

Replaces the reference's cereal binary serialization of the polymorphic object
graph (flat_db/index_db save/load, databases.hpp:158-166,300-330;
quantizers.hpp:170-187). Arrays are stored as an .npz (one entry per field) and
a JSON manifest records the type and static metadata — shardable per host by
storing each host's partition subset (see dist/).
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np

from qadc_tpu.index.flat import FlatIndex
from qadc_tpu.index.ivf import IVFIndex
from qadc_tpu.quantizers.pq import ProductQuantizer
from qadc_tpu.quantizers.opq import OPQQuantizer

FORMAT_VERSION = 1


def _pq_arrays(pq, prefix: str):
    arrays = {f"{prefix}centroids": np.asarray(pq.centroids, np.float32)}
    meta = {"sq_bits": pq.sq_bits, "type": "opq" if isinstance(pq, OPQQuantizer) else "pq"}
    if isinstance(pq, OPQQuantizer):
        arrays[f"{prefix}rotation"] = np.asarray(pq.rotation, np.float32)
    return arrays, meta


def _pq_from(arrays, meta, prefix: str):
    if meta["type"] == "opq":
        return OPQQuantizer(
            centroids=jnp.asarray(arrays[f"{prefix}centroids"]),
            sq_bits=int(meta["sq_bits"]),
            rotation=jnp.asarray(arrays[f"{prefix}rotation"]),
        )
    return ProductQuantizer(
        centroids=jnp.asarray(arrays[f"{prefix}centroids"]),
        sq_bits=int(meta["sq_bits"]),
    )


def save_index(path: str, index):
    """Save a FlatIndex or IVFIndex to `path` (directory)."""
    os.makedirs(path, exist_ok=True)
    pq_arrays, pq_meta = _pq_arrays(index.pq, "pq_")
    if isinstance(index, FlatIndex):
        manifest = {"format": FORMAT_VERSION, "type": "flat", "n": index.n, "pq": pq_meta}
        arrays = {"codes": np.asarray(index.codes), **pq_arrays}
    elif isinstance(index, IVFIndex):
        manifest = {
            "format": FORMAT_VERSION,
            "type": "ivf",
            "n": index.n,
            "max_part_size": index.max_part_size,
            "pq": pq_meta,
        }
        arrays = {
            "codes": np.asarray(index.codes),
            "labels": np.asarray(index.labels),
            "part_sizes": np.asarray(index.part_sizes),
            "coarse_centroids": np.asarray(index.coarse_centroids, np.float32),
            **pq_arrays,
        }
    else:
        raise TypeError(f"unsupported index type {type(index)}")
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def save_index_sharded(path: str, index: IVFIndex, num_shards: int):
    """Save an IVFIndex as per-shard partition slices + shared metadata.

    Multi-host serving restarts load only their slice (SURVEY §5.3-5.4: the
    reference has no elasticity; here each host's shard is independently
    loadable so a job can restart host-by-host). Partition count is padded to
    a shard multiple by empty partitions.
    """
    if not isinstance(index, IVFIndex):
        raise TypeError("sharded checkpoints are for IVFIndex")
    os.makedirs(path, exist_ok=True)
    p = index.part_count
    p_pad = -(-p // num_shards) * num_shards
    codes = np.asarray(index.codes)
    labels = np.asarray(index.labels)
    sizes = np.asarray(index.part_sizes)
    coarse = np.asarray(index.coarse_centroids, np.float32)
    if p_pad != p:
        extra = p_pad - p
        codes = np.concatenate([codes, np.zeros((extra, *codes.shape[1:]), codes.dtype)])
        labels = np.concatenate([labels, np.zeros((extra, labels.shape[1]), labels.dtype)])
        sizes = np.concatenate([sizes, np.zeros((extra,), sizes.dtype)])
        coarse = np.concatenate([coarse, np.full((extra, coarse.shape[1]), 1e30, np.float32)])
    per = p_pad // num_shards
    pq_arrays, pq_meta = _pq_arrays(index.pq, "pq_")
    manifest = {
        "format": FORMAT_VERSION,
        "type": "ivf_sharded",
        "n": index.n,
        "max_part_size": index.max_part_size,
        "num_shards": num_shards,
        "parts_per_shard": per,
        "pq": pq_meta,
    }
    np.savez(
        os.path.join(path, "shared.npz"), coarse_centroids=coarse, **pq_arrays
    )
    for s in range(num_shards):
        sl = slice(s * per, (s + 1) * per)
        np.savez(
            os.path.join(path, f"shard_{s:05d}.npz"),
            codes=codes[sl], labels=labels[sl], part_sizes=sizes[sl],
        )
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_index_shard(path: str, shard_id: int):
    """Load one host's slice of a sharded IVF checkpoint.

    Returns (IVFIndex with only this shard's partitions, manifest dict). The
    index's coarse_centroids remain GLOBAL (replicated); partition ids in the
    slice are local [0, parts_per_shard) — offset = shard_id * parts_per_shard.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["type"] != "ivf_sharded":
        raise ValueError(f"not a sharded checkpoint: {manifest['type']}")
    shared = np.load(os.path.join(path, "shared.npz"))
    pq = _pq_from(shared, manifest["pq"], "pq_")
    arr = np.load(os.path.join(path, f"shard_{shard_id:05d}.npz"))
    return (
        IVFIndex(
            pq=pq,
            coarse_centroids=jnp.asarray(shared["coarse_centroids"]),
            codes=jnp.asarray(arr["codes"]),
            labels=jnp.asarray(arr["labels"]),
            part_sizes=jnp.asarray(arr["part_sizes"]),
            n=int(manifest["n"]),
            max_part_size=int(manifest["max_part_size"]),
        ),
        manifest,
    )


def load_index_rows(path: str, lo: int, hi: int):
    """Load global partition rows [lo, hi) of a sharded IVF checkpoint.

    Reshard-on-load primitive: the requested range may span several shard
    files (a checkpoint written for k hosts served by p != k processes) and
    may extend past the stored partition count, in which case the tail is
    zero-filled empty partitions. Returns (IVFIndex slice, manifest); the
    coarse centroids stay GLOBAL (replicated) and are NOT padded here —
    callers pad them to their own global partition count.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["type"] != "ivf_sharded":
        raise ValueError(f"not a sharded checkpoint: {manifest['type']}")
    if not 0 <= lo <= hi:
        raise ValueError(f"bad row range [{lo}, {hi})")
    per = int(manifest["parts_per_shard"])
    stored = per * int(manifest["num_shards"])
    shared = np.load(os.path.join(path, "shared.npz"))
    pq = _pq_from(shared, manifest["pq"], "pq_")

    codes_l, labels_l, sizes_l = [], [], []
    row = lo
    while row < min(hi, stored):
        s = row // per
        s_lo = row - s * per
        s_hi = min(hi - s * per, per)
        arr = np.load(os.path.join(path, f"shard_{s:05d}.npz"))
        codes_l.append(arr["codes"][s_lo:s_hi])
        labels_l.append(arr["labels"][s_lo:s_hi])
        sizes_l.append(arr["part_sizes"][s_lo:s_hi])
        row = s * per + s_hi
    if not codes_l:  # range entirely in the zero-padding tail
        arr = np.load(os.path.join(path, "shard_00000.npz"))
        codes_l.append(arr["codes"][:0])
        labels_l.append(arr["labels"][:0])
        sizes_l.append(arr["part_sizes"][:0])
    codes = np.concatenate(codes_l)
    labels = np.concatenate(labels_l)
    sizes = np.concatenate(sizes_l)
    if hi > stored:
        extra = hi - max(lo, stored)
        codes = np.concatenate(
            [codes, np.zeros((extra, *codes.shape[1:]), codes.dtype)]
        )
        labels = np.concatenate(
            [labels, np.zeros((extra, *labels.shape[1:]), labels.dtype)]
        )
        sizes = np.concatenate([sizes, np.zeros((extra,), sizes.dtype)])
    return (
        IVFIndex(
            pq=pq,
            coarse_centroids=jnp.asarray(shared["coarse_centroids"]),
            codes=jnp.asarray(codes),
            labels=jnp.asarray(labels),
            part_sizes=jnp.asarray(sizes),
            n=int(manifest["n"]),
            max_part_size=int(manifest["max_part_size"]),
        ),
        manifest,
    )


def load_index(path: str):
    """Load an index saved by save_index."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {manifest['format']}")
    arrays = np.load(os.path.join(path, "arrays.npz"))
    pq = _pq_from(arrays, manifest["pq"], "pq_")
    if manifest["type"] == "flat":
        return FlatIndex(
            pq=pq, codes=jnp.asarray(arrays["codes"]), n=int(manifest["n"])
        )
    if manifest["type"] == "ivf":
        return IVFIndex(
            pq=pq,
            coarse_centroids=jnp.asarray(arrays["coarse_centroids"]),
            codes=jnp.asarray(arrays["codes"]),
            labels=jnp.asarray(arrays["labels"]),
            part_sizes=jnp.asarray(arrays["part_sizes"]),
            n=int(manifest["n"]),
            max_part_size=int(manifest["max_part_size"]),
        )
    raise ValueError(f"unknown index type {manifest['type']}")
