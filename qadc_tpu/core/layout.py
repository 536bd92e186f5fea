"""Blocked code layout for the scan.

The reference interleaves codes into 16-code SIMD blocks and pads the final
block by repeating the last code (simd_layout.hpp:41-65). Here codes stay
row-major (N_pad, code_bytes), stored as 128-byte rows; we keep only the
padding convention: the tail is padded by repeating the LAST code, and
padded labels clamp to the last real label (reference quirk: simd_scan.hpp:67,
simd_layout.hpp:47-50 — duplicate results possible, recall tolerates it).
"""

from __future__ import annotations

import numpy as np

# Padding granularity of flat indexes (codes): a multiple of the scan
# kernel's block, so ranges tile evenly.
DEFAULT_BLOCK = 1024


def padded_count(n: int, block: int = DEFAULT_BLOCK) -> int:
    """Smallest multiple of `block` that is >= max(n, 1)."""
    n = max(int(n), 1)
    return -(-n // block) * block


def pad_codes_to_block(codes: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Pad (N, code_bytes) packed codes to a block multiple by repeating the last row.

    Host-side (numpy) — runs once at index build/add time.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    n_pad = padded_count(n, block)
    if n == 0:
        return np.zeros((n_pad, codes.shape[1]), dtype=np.uint8)
    if n_pad == n:
        return codes
    pad = np.broadcast_to(codes[-1], (n_pad - n, codes.shape[1]))
    return np.concatenate([codes, pad], axis=0)


def codes_per_row(code_size: int) -> int:
    """Codes per 128-byte storage row."""
    if 128 % code_size != 0:
        raise ValueError(f"code_size {code_size} must divide 128")
    return 128 // code_size


def to_row128(codes: np.ndarray) -> np.ndarray:
    """(N_pad, code_size) packed codes -> (N_pad/cpr, 128) storage rows.

    Sixteen consecutive 8-byte codes = one 128-byte row, so the conversion
    is a host-side reshape, and a scan window of codes-per-row codes is one
    storage row (the rerank's row gathers rely on it).
    """
    n, cb = codes.shape
    cpr = codes_per_row(cb)
    if n % cpr != 0:
        raise ValueError(f"N {n} must be a multiple of {cpr}")
    return np.ascontiguousarray(codes).reshape(n // cpr, 128)


def from_row128(rows: np.ndarray, code_size: int) -> np.ndarray:
    """Inverse of to_row128."""
    r, width = rows.shape
    assert width == 128
    cpr = codes_per_row(code_size)
    return np.ascontiguousarray(rows).reshape(r * cpr, code_size)


def pad_labels_to_block(labels: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Pad (N,) labels to a block multiple by repeating the last label."""
    labels = np.asarray(labels, dtype=np.int32)
    n = labels.shape[0]
    n_pad = padded_count(n, block)
    if n == 0:
        return np.zeros((n_pad,), dtype=np.int32)
    if n_pad == n:
        return labels
    pad = np.full((n_pad - n,), labels[-1], dtype=np.int32)
    return np.concatenate([labels, pad], axis=0)
