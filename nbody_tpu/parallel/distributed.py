"""Multi-host initialization.

The reference's process bootstrap is ``MPI_Init`` + rank/size bookkeeping
(ver5_all/GSimulation.cpp:93-115).  The equivalent here is
``jax.distributed.initialize()``: every process then sees the global
device set, and the same mesh/shard_map code paths run over NCCL (NVLink
within a host) with no transport code here."""

from __future__ import annotations

from typing import Optional


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> tuple[int, int]:
    """Initialize multi-host JAX (idempotent).  Returns (process_id,
    process_count).

    Explicit arguments win; otherwise the JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID environment variables (what
    scripts/pod_run.sh exports — the mpirun -n analog) are used; with
    neither, jax's own cluster auto-detection handles Slurm/OpenMPI
    launchers."""
    import os

    import jax

    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS") or env.get(
            "COORDINATOR_ADDRESS"
        )
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        msg = str(e).lower()
        if "already" in msg:
            pass  # initialized earlier in this process — fine
        elif "must be called before" in msg and num_processes in (None, 1):
            # Backends are already up but this is a single-process run, so
            # there is nothing to coordinate; proceed.
            pass
        else:
            raise
    return jax.process_index(), jax.process_count()
