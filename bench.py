#!/usr/bin/env python
"""Benchmark entry point.

Runs the flagship single-device configuration (BASELINE.md config 2:
N=16384, 500 steps, ``--kernel auto``) on the GPU and prints ONE JSON
line:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

The metric is sustained GFLOP/s under the reference's own FLOP model
(29 N^2 + 19 N per step, ver0/GSimulation.cpp:122).  vs_baseline compares
against the reference's published ver0 number (4.0513 GFlop/s,
README.md:56; see BASELINE.md).  Every line names the device it ran on;
without a GPU the script prints a zero-valued line and exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

REFERENCE_GFLOPS = 4.0513  # ver0 published average (BASELINE.md)

# BASELINE.md benchmark configurations: (name, precision, N, timed steps,
# kernel-override[, extra SimConfig kwargs]).  Small-N configs use long
# step counts so the timing signal dominates per-run jitter.  A None
# kernel uses the --kernel argument; the pm rows pin the O(N log N) mesh
# tier, whose gflops_model/pairs_per_sec report EQUIVALENT exact-model
# work per second (the mesh solve does O(ng^3 log ng + N) actual work).
# The periodic row boxes the reference's U(0,1)^3 ICs at L=1.  Every
# sample block is one executable.
SUITE = (
    ("parity-n2000", "f32", 2000, 20000, None),
    ("single-chip-n16384", "f32", 16384, 500, None),
    ("bf16-n131072", "bf16", 131072, 100, None),
    ("n1m", "f32", 1048576, 4, None),
    ("n4m", "f32", 4194304, 2, None),
    ("n4m-pm-equivalent", "f32", 4194304, 8, "pm"),
    ("n1m-p3m-equivalent", "f32", 1048576, 8, "p3m"),
    ("n1m-p3m-periodic", "f32", 1048576, 8, "p3m",
     {"pm_boundary": "periodic", "pm_box": 1.0}),
)


def _device() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _suite(kernel: str) -> int:
    from nbody_tpu.config import SimConfig
    from nbody_tpu.utils.flops import pairs_per_step, step_gflops

    device = _device()
    for name, precision, n, steps, kernel_pin, *extra in SUITE:
        cfg = SimConfig(n=n, nsteps=steps, kernel=kernel_pin or kernel,
                        precision=precision,
                        **(extra[0] if extra else {}))
        half = max(1, steps // 2)
        t_half = _timed_steps(cfg, half)
        t_full = _timed_steps(cfg, 2 * half)
        sps = half / max(t_full - t_half, 1e-9)
        row = {
            "config": name,
            "n": n,
            "precision": precision,
            "gflops_model": round(step_gflops(n) * sps, 2),
            "pairs_per_sec": f"{pairs_per_step(n) * sps:.4g}",
            "steps_per_sec": round(sps, 4),
            "device": device,
        }
        if kernel_pin:
            row["kernel"] = kernel_pin
        print(json.dumps(row), flush=True)
    return 0


def _env_fn(cfg):
    """Per-block frozen mesh env for pm/p3m rows — the engine's wiring
    (simulation._mesh_env_fn), mirrored so bench times the production
    step."""
    from nbody_tpu.ops.registry import resolve

    resolved = resolve(cfg.kernel)
    if resolved not in ("pm", "p3m") or cfg.pm_boundary == "periodic":
        return None
    from nbody_tpu.ops import pm as pm_ops

    ko = cfg.kernel_opts()
    cutoff = ko.get("cutoff_cells", 0)
    if resolved == "p3m":
        cutoff = cutoff or pm_ops.DEFAULT_CUTOFF_CELLS
    kw = dict(grid=ko.get("grid", pm_ops.DEFAULT_GRID),
              cutoff_cells=cutoff)
    return lambda pos, mass: pm_ops.make_mesh_env(pos, mass, **kw)


def _timed_steps(cfg, nsteps, distribution="reference"):
    """Wall time for an nsteps on-device run (one warm-started block fn),
    best of three."""
    from nbody_tpu.init import make_state
    from nbody_tpu.models.gravity import make_accel_fn, make_block_fn

    state = make_state(cfg.n, pad_multiple=cfg.pad_multiple(),
                       distribution=distribution,
                       seed=42 if distribution == "reference" else 7)
    # P3M rows run on the MEASURED short-range plan, exactly like an
    # engine run; mutating cfg here also lets the second _timed_steps
    # call of a difference pair reuse the plan.
    cfg.resolve_sr_plan(state.pos, state.mass)
    if cfg.shards > 1:
        from nbody_tpu.parallel.decompose import (
            make_sharded_block_fn,
            shard_state,
        )

        state, mesh = shard_state(state, cfg.shards)
        blk = make_sharded_block_fn(
            cfg.kernel, cfg.kernel_opts(), cfg.dt, nsteps, mesh, comm=cfg.comm
        )
    else:
        blk = make_block_fn(
            make_accel_fn(cfg.kernel, **cfg.kernel_opts()), cfg.dt, nsteps,
            env_fn=_env_fn(cfg),
        )
    out, ke = blk(state)
    float(ke)  # compile + execute once
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out, ke = blk(state)
        float(ke)
        best = min(best, time.perf_counter() - t0)
    return best


def _fidelity(kernel: str) -> dict:
    """The BASELINE.json fidelity gate, certified inside the headline
    artifact: run the reference's default config (N=2000, 500 steps) and
    compare the kenergy trace against the committed g++ ver0 golden
    capture at full printed precision (%.5g strings)."""
    import os

    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run as sim_run
    from nbody_tpu.utils.reporting import _g5, parse_trace

    golden_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "tests", "golden", "ver0_n2000_s500.txt",
    )
    try:
        with open(golden_path) as f:
            golden = parse_trace(f.read())
    except OSError:
        return {"trace_match": None}
    res = sim_run(SimConfig(n=2000, nsteps=500, kernel=kernel), quiet=True)
    ours = {s: ke for (s, _, ke, _, _) in res.samples}
    match = bool(golden)
    max_rel = 0.0
    for s, ke_str in golden:
        ke = ours.get(s)
        if ke is None or _g5(ke) != ke_str:
            match = False
        if ke is not None and float(ke_str):
            max_rel = max(max_rel, abs(ke - float(ke_str)) / abs(float(ke_str)))
    return {
        "trace_match": match,
        "ke_max_rel_err_vs_ref": float(f"{max_rel:.2e}"),
    }


def main(argv=None) -> int:
    import argparse

    from nbody_tpu.utils.platform import enable_compilation_cache

    enable_compilation_cache()

    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--kernel", default="auto")
    p.add_argument("--shards", type=int, default=1,
                   help="particle-shard the run over this many devices "
                        "(ring comm)")
    p.add_argument("--suite", action="store_true",
                   help="run every BASELINE.md config (one JSON line per "
                        "config)")
    args = p.parse_args(argv)

    from nbody_tpu.config import SimConfig
    from nbody_tpu.utils.flops import pairs_per_step, step_gflops

    metric = "sustained GFLOP/s (reference flop model, N=%d)" % args.n
    device = _device()
    if device["platform"] != "gpu":
        # Still exactly ONE JSON line, zero-valued with the reason, and
        # a non-zero exit: a CPU number must never pass for a GPU one.
        print(json.dumps({
            "metric": metric, "value": 0.0, "unit": "GFLOP/s",
            "vs_baseline": 0.0, "device": device,
            "error": f"no GPU: JAX's default device is {device['platform']}",
        }))
        return 1

    if args.suite:
        return _suite(args.kernel)

    cfg = SimConfig(n=args.n, nsteps=args.steps, kernel=args.kernel,
                    shards=args.shards, comm="ring")

    # Difference-method timing: run L and 2L steps, attribute T(2L)-T(L)
    # to L steps, which cancels fixed per-run costs (dispatch and the
    # final device->host fetch).
    half = max(1, args.steps // 2)
    t_half = _timed_steps(cfg, half)
    t_full = _timed_steps(cfg, 2 * half)
    steps_per_sec = half / max(t_full - t_half, 1e-9)

    value = step_gflops(args.n) * steps_per_sec
    pair_rate = pairs_per_step(args.n) * steps_per_sec
    payload = {
        "metric": metric,
        "value": round(value, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(value / REFERENCE_GFLOPS, 2),
        "pair_interactions_per_sec": f"{pair_rate:.4g}",
        "config": {
            "n": args.n,
            "nsteps": args.steps,
            "kernel": args.kernel,
        },
        "device": device,
    }
    # Fidelity north-star (BASELINE.json metric triple): golden-trace
    # agreement rides along so each artifact certifies both the
    # throughput and the correctness gate by itself.
    payload.update(_fidelity(args.kernel))
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
