#!/usr/bin/env python
"""Weak/strong-scaling benchmark across shard counts and comm modes.

On a multi-GPU host it measures pair rate per shard for {allgather,
ring} at each power-of-two shard count the device set supports.  On one
card it degenerates to shards=1 (and on a CPU host it exercises the
virtual mesh — numbers then validate plumbing, not hardware).

Usage: python scripts/scaling_bench.py [N] [--weak] [--steps K]
  strong scaling (default): global N fixed, shards grow
  --weak: N per shard fixed at N, global N grows with shards
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("n", nargs="?", type=int, default=131072)
    p.add_argument("--weak", action="store_true")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--comms", default="allgather,ring")
    args = p.parse_args()

    import jax

    from nbody_tpu.init import make_state
    from nbody_tpu.parallel.decompose import make_sharded_block_fn, shard_state
    from nbody_tpu.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    shard_counts = [s for s in (1, 2, 4, 8, 16, 32) if s <= ndev]

    for shards in shard_counts:
        n = args.n * shards if args.weak else args.n
        state = make_state(n, pad_multiple=2048 * shards)
        mesh = make_mesh(shards)
        sharded, _ = shard_state(state, shards, mesh=mesh)
        for comm in args.comms.split(","):
            try:
                blk = make_sharded_block_fn(
                    "auto", {}, 0.1, args.steps, mesh, comm=comm
                )
                out, ke = blk(sharded)
                float(ke)  # compile+run
                t0 = time.perf_counter()
                out, ke = blk(sharded)
                float(ke)
                t1 = time.perf_counter()
                blk2 = make_sharded_block_fn(
                    "auto", {}, 0.1, 2 * args.steps, mesh, comm=comm
                )
                out, ke = blk2(sharded)
                float(ke)
                t2 = time.perf_counter()
                out, ke = blk2(sharded)
                float(ke)
                per_step = max(time.perf_counter() - t2 - (t1 - t0), 1e-9) / args.steps
                rate = float(n) * n / per_step
                print(json.dumps({
                    "shards": shards, "comm": comm, "n": n,
                    "pairs_per_sec": f"{rate:.4g}",
                    "pairs_per_sec_per_shard": f"{rate / shards:.4g}",
                    "steps_per_sec": round(1.0 / per_step, 4),
                }), flush=True)
            except Exception as e:
                print(json.dumps({
                    "shards": shards, "comm": comm, "n": n,
                    "error": f"{type(e).__name__}: {str(e)[:120]}",
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
