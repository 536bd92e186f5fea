"""Tracing / profiling helpers.

Reference (SURVEY §5.1): hand-rolled ustime() phase timers emitted as CSV.
Here: the same phase metrics (eval/metrics.py) plus kernel-level tracing via
jax.profiler — traces open in XProf/TensorBoard and attribute time to the
scan kernel, collectives, and gathers individually. Wall-clock timing of
calls lives in eval/timing.py.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace of the enclosed block into log_dir.

    View with: tensorboard --logdir <log_dir> (Profile tab), or xprof.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named sub-span inside a trace (context manager)."""
    return jax.profiler.TraceAnnotation(name)
