"""Device mesh setup.

The reference is single-node shared-memory (SURVEY.md §2.3); distribution here
is a new first-class subsystem: a 1-D `shard` mesh over all devices
(jax.distributed handles multi-host process groups). Every collective in dist/
is issued by XLA, which hands it to NCCL: over NVLink between the GPUs of one
host, all to all, so the mesh needs no topology shape.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over the first n devices (default all)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def maybe_init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed for multi-host runs; safe to call anywhere.

    Resolution order: explicit args > QADC_COORDINATOR/QADC_NUM_PROCESSES/
    QADC_PROCESS_ID env vars > (only if QADC_DISTRIBUTED=auto) jax's own
    cluster auto-detection (SLURM etc.). The auto-detect probe is
    opt-in because in partially-configured environments (cluster metadata
    reachable but coordinator down, stale SLURM vars) it can BLOCK instead of
    raising — the default must stay a guaranteed no-op for single-process
    runs.

    Returns True when a multi-process group is (or already was) initialized.
    """
    import os

    if jax.distributed.is_initialized():  # already initialized
        return jax.process_count() > 1

    coordinator_address = coordinator_address or os.environ.get("QADC_COORDINATOR")
    if num_processes is None and "QADC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["QADC_NUM_PROCESSES"])
    if process_id is None and "QADC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["QADC_PROCESS_ID"])

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    # No explicit config: the no-arg cluster probe (SLURM, GKE) can
    # hang rather than raise when an environment is half-configured, so it is
    # opt-in via QADC_DISTRIBUTED=auto; default is a no-op.
    if os.environ.get("QADC_DISTRIBUTED") == "auto":
        try:
            jax.distributed.initialize()
            return jax.process_count() > 1
        except Exception:
            return False
    return False
