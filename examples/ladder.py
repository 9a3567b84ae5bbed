#!/usr/bin/env python
"""The optimization ladder, as kernels of one framework.

The reference teaches performance as nine programs (ver0-ver8) run one
after another.  Here the rungs are kernels and precision modes of one
framework; this example runs them on the same problem and prints the
same-style comparison the workshop builds by hand.  A rung that fails
makes the script exit non-zero.

Usage: python examples/ladder.py [N] [steps] [--interpret]
(--interpret runs the Pallas rungs in the interpreter, e.g. on a CPU)
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--interpret"]
    pallas = {"interpret": True} if "--interpret" in sys.argv else {}
    n = int(args[0]) if args else 16384
    steps = int(args[1]) if len(args) > 1 else 100

    import jax

    from nbody_tpu.init import make_state
    from nbody_tpu.models.gravity import make_accel_fn, make_block_fn
    from nbody_tpu.utils.flops import step_gflops

    rungs = [
        ("naive jnp (ver0-2 analog)", "naive", {}),
        ("pallas tiled (ver3-8 analog)", "pallas", pallas),
        ("pallas bf16-dist", "pallas", dict(pallas, dist_dtype="bfloat16")),
        # Beyond the exact ladder: the O(N log N) mesh tiers (rates are
        # not pair-rate-comparable — the FLOP model is the exact one).
        ("particle-mesh O(N log N)", "pm", {}),
        ("p3m mesh + exact short-range", "p3m", {}),
    ]
    def diff_time(blk):
        """Per-step seconds via difference timing: run the block once and
        twice, attribute the difference to one block (cancels the fixed
        dispatch/fetch cost)."""
        def t_of(k):
            st = state
            for _ in range(k):
                st, ke = blk(st)
            float(ke)
            t0 = time.perf_counter()
            st = state
            for _ in range(k):
                st, ke = blk(st)
            float(ke)
            return time.perf_counter() - t0

        return max(t_of(2) - t_of(1), 1e-9) / steps

    state = make_state(n, pad_multiple=1024)
    print(f" N={n}, {steps} steps per rung, backend={jax.default_backend()}")
    print(f" {'rung':32s} {'time/step':>12s} {'GFlop/s':>10s} {'speedup':>8s}")
    base = None
    failed = 0
    for label, kernel, opts in rungs:
        try:
            blk = make_block_fn(make_accel_fn(kernel, **opts), 0.1, steps)
            dt = diff_time(blk)
        except Exception as e:  # noqa: BLE001 — reported, counted, exit 1
            print(f" {label:32s} FAILED: {type(e).__name__}: {e}")
            failed += 1
            continue
        gf = step_gflops(n) / dt
        base = base or dt
        print(f" {label:32s} {dt * 1e3:>10.3f}ms {gf:>10.1f} {base / dt:>7.2f}x")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
