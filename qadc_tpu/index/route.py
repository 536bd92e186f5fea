"""Route choice: which search path runs, and which scan implementation.

This is the one place that reads the platform. Every search entry point asks
`choose` and follows its answer:

  path  "direct"  exact float ADC over every probed code (small batches);
        "grouped" partition-grouped window scan + whole-window rerank;
        "window"  flat window scan + whole-window rerank;
        "loop"    per-assignment (IVF) or chunked (flat) plain scan.
  scan  "triton"  the compiled Pallas kernel (GPU);
        "xla"     the plain-XLA twin (no kernel);
        "interpret" the kernel in the Pallas interpreter (CPU tests only).

On a GPU the grouped, window and direct paths are the defaults, under the
geometry rules below. A CPU takes the plain paths unless a caller asks for a
path explicitly, or passes interpret=True to exercise the GPU routes with the
kernel interpreted. interpret=True on an accelerator raises: the compiled
kernel runs there, never the interpreter.
"""

from __future__ import annotations

import dataclasses

import jax

from qadc_tpu.kernels.window_scan import DEFAULT_WINDOW

# Largest probed-code volume (q * ma * part_pad) that the direct exact path
# takes by default: it touches every probed code with float tables, so it
# wins only while the volume is small (b=1..4 at SIFT1M geometry). Untuned
# on the H100 (ROADMAP).
DIRECT_MAX_CODES = 600_000

# Probe density (live (query, assignment) pairs per probed partition) at or
# below which the direct path is taken whatever the volume: a group's table
# slab is G slots wide whatever its live count, so at density d the grouped
# scan does G/d times the useful work. Untuned on the H100 (ROADMAP).
DIRECT_MAX_DENSITY = 1.5

# Partition padding granularity the grouped scan needs (index.ivf.PART_ALIGN).
_GROUPED_ALIGN = 512
_FLAT_ALIGN = 1024


@dataclasses.dataclass(frozen=True)
class Route:
    path: str
    scan: str


def scan_impl(interpret: bool = False) -> str:
    """Scan implementation for this process's platform."""
    platform = jax.default_backend()
    if interpret:
        if platform != "cpu":
            raise ValueError(
                f"interpret=True is for CPU tests; on {platform} the "
                "compiled kernel runs"
            )
        return "interpret"
    return "triton" if platform == "gpu" else "xla"


def choose(
    op: str, index, *, q: int = 1, ma: int = 1, r: int = 100,
    rerank: bool = True, saturate: bool = False,
    grouped: bool | None = None, direct: bool | None = None,
    interpret: bool = False,
) -> Route:
    """Route for one search call.

    op: "ivf_qadc" | "ivf_adc" | "flat_qadc" | "flat_sharded_qadc".
    grouped / direct: a caller's explicit choice (None = decide here). For
      "flat_qadc" and "flat_sharded_qadc", grouped selects the window path.
    For "flat_sharded_qadc", q is the per-shard code count and r the
    per-shard candidate count.
    """
    scan = scan_impl(interpret)
    accel = scan != "xla"
    pq = index.pq
    m, bits = pq.sq_count, pq.sq_bits
    if op == "ivf_qadc":
        if direct is None:
            qa = q * ma
            density = qa / max(1, min(index.part_count, qa))
            direct = (
                accel and rerank and not saturate and m in (16, 32)
                and (qa * index.part_pad <= DIRECT_MAX_CODES
                     or density <= DIRECT_MAX_DENSITY)
            )
        if direct:
            return Route("direct", "xla")
        if grouped is None:
            grouped = accel and m in (16, 32) and index.part_pad % _GROUPED_ALIGN == 0
        return Route("grouped", scan) if grouped else Route("loop", "xla")
    if op == "ivf_adc":
        if grouped is None:
            aligned = index.part_pad % _GROUPED_ALIGN == 0
            grouped = aligned and (
                bits == 16
                or (accel and bits == 8 and 128 % m == 0)
                or (accel and bits == 4 and m in (16, 32))
            )
        return Route("grouped" if grouped else "loop", "xla")
    if op == "flat_qadc":
        if grouped is None:
            n_pad = index.n_pad
            grouped = (
                accel and m in (16, 32) and n_pad % _FLAT_ALIGN == 0
                and n_pad // DEFAULT_WINDOW >= 8 * r
            )
        return Route("window", scan) if grouped else Route("loop", "xla")
    if op == "flat_sharded_qadc":
        if grouped is None:
            grouped = (
                accel and m in (16, 32) and q % _FLAT_ALIGN == 0
                and q // DEFAULT_WINDOW >= 2 * r
            )
        return Route("window", scan) if grouped else Route("loop", "xla")
    raise ValueError(f"unknown search op {op!r}")
