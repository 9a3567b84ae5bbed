#!/usr/bin/env bash
# Multi-process launcher — the analog of the reference's
# cluster wrapper (/root/reference/run_slurm.sh:2-23, which wires a Slurm
# job's core count into OMP_NUM_THREADS and runs the binary under mpirun
# semantics).  Here the per-process wiring is the jax.distributed
# coordinator triplet; the same simulation code runs unchanged.
#
# Usage:
#   scripts/pod_run.sh NPROCS [python -m nbody_tpu args...]
#
# Local smoke mode (any machine, no accelerator needed):
#   scripts/pod_run.sh 2 512 5 --platform cpu --shards 8 --kernel naive
#   spawns NPROCS processes on this host, each hosting shards/NPROCS
#   virtual CPU devices, joined into ONE global mesh via a local
#   coordinator.  Rank 0 prints the usual table; other ranks are silent
#   (reference behavior: ver5_all/GSimulation.cpp:119 gates on rank 0).
#
# GPU host: rank i is given card i alone (CUDA_VISIBLE_DEVICES), since
# a JAX process reserves most of the memory of every card it opens.  An
# existing CUDA_VISIBLE_DEVICES list is split the same way.
#
# Real multi-host mode:
#   * Slurm: `srun -n NPROCS python -m nbody_tpu ...` — jax's SlurmCluster
#     auto-detects rank/size/coordinator from the Slurm environment.
#   * Anything else: export JAX_COORDINATOR_ADDRESS=host0:port,
#     JAX_NUM_PROCESSES, JAX_PROCESS_ID per process (what this script
#     does for the local case).
set -euo pipefail

NPROCS="${1:?usage: pod_run.sh NPROCS [nbody_tpu args...]}"
shift

PORT="${NBODY_COORDINATOR_PORT:-$(python -c '
import socket
s = socket.socket(); s.bind(("127.0.0.1", 0))
print(s.getsockname()[1]); s.close()')}"
LOGDIR="${NBODY_LOG_DIR:-$(mktemp -d -t nbody_pod.XXXXXX)}"
echo "# pod_run: $NPROCS processes, coordinator 127.0.0.1:$PORT, logs in $LOGDIR" >&2

IFS=, read -r -a CARDS <<<"${CUDA_VISIBLE_DEVICES:-$(seq -s, 0 $((NPROCS - 1)))}"

pids=()
for ((i = 0; i < NPROCS; i++)); do
  CUDA_VISIBLE_DEVICES="${CARDS[i]:-$i}" \
  JAX_COORDINATOR_ADDRESS="127.0.0.1:$PORT" \
  JAX_NUM_PROCESSES="$NPROCS" \
  JAX_PROCESS_ID="$i" \
  python -m nbody_tpu "$@" \
    >"$LOGDIR/rank$i.out" 2>"$LOGDIR/rank$i.err" &
  pids+=($!)
done

rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=$?
done

cat "$LOGDIR/rank0.out"
if ((rc != 0)); then
  echo "# pod_run: a rank failed (rc=$rc); stderr tails:" >&2
  for ((i = 0; i < NPROCS; i++)); do
    echo "--- rank $i ---" >&2
    tail -5 "$LOGDIR/rank$i.err" >&2 || true
  done
fi
exit "$rc"
