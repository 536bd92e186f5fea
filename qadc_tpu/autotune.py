"""Measured per-geometry scan-parameter autotuning (opt-in, cached).

The grouped scan path ships fixed defaults — block_n = DEFAULT_BLOCK_N codes
per kernel program, window = codes-per-storage-row. Other geometries may
prefer other values. This module times the REAL search at the index's true
geometry on the live device (host clock around block_until_ready,
eval/timing.py) and caches the winning parameters keyed by (device kind,
path, geometry, batch bucket), in memory and on disk.

Opt-in two ways:
  - explicit: ``pick = tune_ivf_qadc(index, queries, r=, ma=, keep=)`` at
    index-load time; subsequent ``search_qadc`` calls read the recorded pick
    automatically (when the caller did not pass block_n/grouped_window).
  - env ``QADC_AUTOTUNE=1``: search wrappers tune lazily on the first call
    per (geometry, batch bucket). Each candidate costs one compile, so
    first-call latency is long — production should ship the cache file
    instead (``QADC_AUTOTUNE_CACHE``).

The reference has no analog (its scan blocks are fixed by SIMD register
shape, simd_scan.hpp:125-187); here the right block is a measured property
of geometry x compiler x device, hence tuned, not hardcoded.
"""

from __future__ import annotations

import json
import os
import threading

_mem: dict[str, dict] = {}
_disk_loaded = False
_lock = threading.Lock()


def _cache_path() -> str:
    return os.environ.get(
        "QADC_AUTOTUNE_CACHE",
        os.path.join(
            os.path.expanduser("~"), ".cache", "qadc_tpu", "autotune.json"
        ),
    )


def _bundled_defaults_path() -> str:
    return os.path.join(os.path.dirname(__file__), "autotune_defaults.json")


def _load_disk() -> None:
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    # User cache first (its entries win), then the bundled measured defaults
    # shipped with the package (autotune_defaults.json; empty until picks
    # are measured on the supported device) so a fresh install starts from
    # a measured pick instead of the fixed heuristic.
    for path in (_cache_path(), _bundled_defaults_path()):
        try:
            with open(path) as f:
                on_disk = json.load(f)
        except (OSError, ValueError):
            continue
        for k, v in on_disk.items():
            _mem.setdefault(k, v)


def _save_disk() -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_mem, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is an optimization; never fail a search over it


def batch_bucket(q: int) -> int:
    """Quantize batch size to the serving buckets so one tuning run covers a
    range of nearby batch sizes (1, 8, 32, 128, 512, 2048).

    512 and 2048 are SEPARATE buckets deliberately: a smaller window doubles
    the window-minimum stream, which at large batches can push the
    scan-budget governor into query chunking, so one pick must not cover
    both.
    """
    for b in (1, 8, 32, 128, 512):
        if q <= b:
            return b
    return 2048


def geometry_key(index, path: str, q: int) -> str:
    import jax

    pq = index.pq
    parts = getattr(index, "part_count", 0)
    pp = getattr(index, "part_pad", 0)
    return (
        f"{jax.devices()[0].device_kind}|{path}|m{pq.sq_count}x{pq.sq_bits}"
        f"|d{pq.dim}|pp{pp}|parts{parts}|b{batch_bucket(q)}"
    )


def lookup(key: str) -> dict:
    with _lock:
        _load_disk()
        return dict(_mem.get(key, {}))


def record(key: str, pick: dict) -> None:
    with _lock:
        _load_disk()
        _mem[key] = dict(pick)
        _save_disk()


def enabled() -> bool:
    return os.environ.get("QADC_AUTOTUNE", "").strip() in ("1", "true", "on")


def tune_ivf_qadc(
    index,
    queries,
    r: int = 100,
    ma: int = 24,
    keep: float = 0.00213,
    block_candidates=(512, 1024, 2048),
    window_candidates=None,
    iters: int = 5,
    verbose: bool = False,
    interpret: bool = False,
) -> dict:
    """Measure the grouped Quick-ADC search over candidate (block_n,
    grouped_window) pairs at this index's geometry and record the winner.

    Returns the winning pick, e.g. {"block_n": 1024, "grouped_window": 16}.
    """
    import jax.numpy as jnp

    from qadc_tpu.core.layout import codes_per_row
    from qadc_tpu.eval.timing import median_seconds
    from qadc_tpu.index import ivf
    from qadc_tpu.kernels.window_scan import DEFAULT_BLOCK_N

    queries = jnp.asarray(queries)
    cpr = codes_per_row(index.pq.code_size)
    if window_candidates is None:
        base_w = min(cpr, 16)
        window_candidates = sorted({base_w, max(base_w // 2, 1)})
    # Candidate blocks must divide part_pad (kernel grid constraint).
    pp = index.part_pad or 512
    cands = [
        (bn, w) for bn in block_candidates if pp % bn == 0
        for w in window_candidates if bn % w == 0
    ]
    if not cands:
        return {}

    def measure(pick, n):
        return median_seconds(
            lambda: ivf.search_qadc(
                index, queries, r=r, ma=ma, keep=keep, grouped=True,
                direct=False, grouped_window=pick["grouped_window"],
                block_n=pick["block_n"], interpret=interpret,
            ),
            iters=n,
        )

    best, best_dt = None, float("inf")
    for bn, w in cands:
        pick = {"block_n": bn, "grouped_window": w}
        try:
            dt = measure(pick, iters)
        except Exception:  # noqa: BLE001 — an invalid candidate loses, not crashes
            continue
        if verbose:
            print(f"autotune ivf_qadc block_n={bn} window={w}: "
                  f"{dt * 1e6:.1f} us/call")
        if dt < best_dt:
            best, best_dt = pick, dt
    # CONFIRM before recording: re-measure the winner against the shipped
    # default with twice the calls; an unconfirmed (<3%) win records the
    # default, so one noisy sample cannot install a slower pick.
    heur = {"block_n": DEFAULT_BLOCK_N, "grouped_window": min(cpr, 16)}
    if best is not None and best != heur and pp % heur["block_n"] == 0:
        try:
            t_best = measure(best, 2 * iters)
            t_heur = measure(heur, 2 * iters)
        except Exception:  # noqa: BLE001 — confirmation failure: keep default
            return {}
        if verbose:
            print(f"autotune confirm: pick {t_best * 1e6:.1f} us/call vs "
                  f"default {t_heur * 1e6:.1f}")
        if t_best > t_heur * 0.97:
            best = heur
    if best is not None:
        record(geometry_key(index, "ivf_qadc_grouped", queries.shape[0]), best)
    return best or {}
