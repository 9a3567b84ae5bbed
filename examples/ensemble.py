#!/usr/bin/env python
"""Ensemble demo: E independent simulations in ONE transformed function.

A capability the reference architecture cannot express: its per-run
state is a heap ``GSimulation`` stepped by nested loops, so a
seed-sweep is E process launches.  Here `jax.vmap` batches the whole
sample block over a member axis (models/ensemble.py) — one jit, one
dispatch, every kernel family (pair sweeps get a batch grid dim, mesh
tiers batch their FFTs) — and, given a device mesh, the member axis
shards with ZERO collectives (embarrassingly parallel data parallelism
over runs).

One vmap'd block amortizes the per-block dispatch over all members
(not yet measured on a GPU); the batched form is also the only one
whose member axis shards over a mesh with zero collectives.

Usage: python examples/ensemble.py [E] [N] [steps] [kernel]
Add --mesh to shard members over all local devices.
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    e = int(args[0]) if len(args) > 0 else 8
    n = int(args[1]) if len(args) > 1 else 512
    steps = int(args[2]) if len(args) > 2 else 50
    kernel = args[3] if len(args) > 3 else "naive"

    import jax
    import numpy as np

    from nbody_tpu.init import make_state
    from nbody_tpu.models.ensemble import (
        make_ensemble_block_fn,
        stack_states,
    )
    from nbody_tpu.models.gravity import make_accel_fn

    mesh = None
    if "--mesh" in sys.argv:
        from nbody_tpu.parallel.mesh import make_mesh

        k = len(jax.local_devices())
        if e % k:
            raise SystemExit(f"E={e} must divide over {k} devices")
        mesh = make_mesh(k)
        print(f"# sharding {e} members over {k} devices "
              "(no collectives)")

    states = [make_state(n, pad_multiple=8, seed=100 + i)
              for i in range(e)]
    ens = stack_states(states)
    blk = make_ensemble_block_fn(make_accel_fn(kernel), 0.1, steps,
                                 mesh=mesh)

    out, kes = blk(ens)  # compile + run
    kes = np.asarray(kes)

    def timed(runs):
        t0 = time.perf_counter()
        for _ in range(runs):
            _, k2 = blk(ens)
        np.asarray(k2)  # value fetch = the only true sync here
        return time.perf_counter() - t0

    # Difference timing: the fixed dispatch + fetch cost cancels
    # between the 1-run and 3-run timings.
    dt = max((timed(3) - timed(1)) / 2, 1e-9)
    for i, ke in enumerate(kes):
        print(f"member {i}: seed={100 + i} kenergy={ke:.4f}")
    print(f"# {e} members x {steps} steps in {dt * 1e3:.1f} ms warm "
          f"({dt * 1e3 / e:.1f} ms/member, difference-timed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
