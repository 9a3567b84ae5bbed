#!/usr/bin/env python
"""Chip smoke test: the main path once on an NVIDIA GPU, checked.

    python chip_smoke.py           # one card: device, parity, exact, mesh
    python chip_smoke.py --multi   # four cards: the sharded path only

Every phase prints one line per check with its numbers; any failed check
raises, so the script exits non-zero.  Without a GPU (or outside a
checkout of this repository) it exits non-zero and prints no result.
The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases (one card):
* device — card name and power limit, JAX version, device kind and
  count, XLA_FLAGS, compile-cache directory;
* parity — the reference's benchmark (N=2000, 500 steps) through the
  engine with kernel auto, naive and pallas, each compared with the g++
  ver0 golden kinetic-energy trace;
* exact  — the pallas and naive kernels against a float64 reference on
  sampled targets at N=16384 and N=1,048,576, then an N=1,048,576 engine
  run with kernel auto (one executable per sample block);
* mesh   — p3m force error on a Plummer sphere (N=262,144) and pm force
  error on the reference ICs (N=1,048,576) against naive, and short p3m,
  pm and periodic p3m (N=1,048,576) runs.

--multi: N=1,048,576 exact with 4 shards (ring and allgather) and sharded
p3m at N=1,048,576, each against the same run on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "ver0_n2000_s500.txt")

# BASELINE.md fidelity gate: the trace must match at printed precision
# (%.5g), or else agree to this relative error at every sample.
FIDELITY_MAX_REL = 1e-4
ENGINE_N = 1048576  # exact engine run, pm and periodic p3m, --multi
P3M_N = 262144  # Plummer p3m
# Norm-wise relative force error against float64 on sampled targets.
# 16384: the CPU fuzz bound (tests/test_kernel_fuzz.py).  1M: float32
# sums over 2^20 terms; a TF32 contraction would show ~1e-3.
KERNEL_TOL = {16384: 5e-6, 1048576: 1e-4}
KERNEL_SAMPLES = 1024
# tests/test_p3m.py::test_p3m_plummer_accuracy bound at the default mesh
# (ng=128, cutoff 4 cells).  That test sizes the cell capacity from the
# measured occupancy, and at N=2048 nothing overflows; at N=262,144 the
# engine's default cap (2048) overflows the core by design (those
# particles get mesh-quality forces), so the bound is checked with the
# capacity that holds the measured occupancy, and the default plan's
# error is reported beside it.
P3M_PLUMMER_TOL = 8e-3
P3M_SAMPLES = 4096
# tests/test_pm.py::test_pm_force_accuracy_vs_naive (unit-box cloud, ng=64).
PM_TOL = 5e-2
# Mesh runs: the CIC deposit scatter-adds with atomics, whose order
# changes from run to run, so two identical runs agree only to rounding.
MESH_REPEAT_TOL = 1e-4
# Sharded vs one card, kinetic energy after the block: exact sweeps only
# reorder float32 sums; the sharded mesh also reorders its grid psum and
# splits the short-range worklist.
MULTI_TOL = {"exact": 1e-5, "p3m": 1e-4}


def say(phase: str, **numbers) -> None:
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {fields}", flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def compare_trace(ours: dict, golden: list) -> tuple[bool, list, float]:
    """(all equal at %.5g, [(step, ours, golden) that differ], max rel
    error) of a {step: kenergy} trace against parsed golden samples."""
    from nbody_tpu.utils.reporting import _g5

    diffs, max_rel = [], 0.0
    for step, ke_str in golden:
        ke = ours.get(step)
        if ke is None:
            diffs.append((step, None, ke_str))
            max_rel = math.inf
            continue
        if _g5(ke) != ke_str:
            diffs.append((step, _g5(ke), ke_str))
        ref = float(ke_str)
        if ref:
            max_rel = max(max_rel, abs(ke - ref) / abs(ref))
    return (bool(golden) and not diffs), diffs, max_rel


def rel_err(a: np.ndarray, ref: np.ndarray) -> float:
    """Norm-wise relative error ||a - ref|| / ||ref||."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-300))


def accel64(pos, mass, idx, chunk: int = 16) -> np.ndarray:
    """Float64 accelerations of targets ``idx`` due to all particles:
    (3, len(idx)), the reference's softened force law."""
    from nbody_tpu.types import G_NEWTON, SOFTENING_SQUARED

    p = np.asarray(pos, np.float64)
    gm = G_NEWTON * np.asarray(mass, np.float64)
    out = np.empty((3, len(idx)))
    for c in range(0, len(idx), chunk):
        t = idx[c:c + chunk]
        d = p[:, None, :] - p[:, t, None]  # (3, c, N)
        d2 = (d * d).sum(0) + SOFTENING_SQUARED
        out[:, c:c + chunk] = (d * (gm / (d2 * np.sqrt(d2)))).sum(-1)
    return out


def ms_per_step(res, sfreq: int) -> float:
    secs = [b for (_, _, _, b, _) in res.samples]
    return 1e3 * float(np.mean(secs)) / sfreq


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device(cache_dir: str) -> None:
    import jax

    devs = jax.devices()
    print(card(), flush=True)  # name, power limit: as nvidia-smi says
    say("device", jax=jax.__version__, kind=f"'{devs[0].device_kind}'",
        count=len(devs), xla_flags=f"'{os.environ.get('XLA_FLAGS', '')}'",
        compile_cache=cache_dir)


def phase_parity() -> None:
    from nbody_tpu.config import SimConfig
    from nbody_tpu.ops.registry import resolve
    from nbody_tpu.simulation import run
    from nbody_tpu.utils.reporting import parse_trace

    with open(GOLDEN) as f:
        golden = parse_trace(f.read())
    for kernel in ("auto", "naive", "pallas"):
        res = run(SimConfig(n=2000, nsteps=500, kernel=kernel), quiet=True)
        ours = {s: ke for (s, _, ke, _, _) in res.samples}
        match, diffs, max_rel = compare_trace(ours, golden)
        say("parity", kernel=kernel, resolved=resolve(kernel),
            trace_match=match, samples_differing=len(diffs),
            max_rel_err=f"{max_rel:.3e}",
            ms_per_step=f"{ms_per_step(res, 50):.4f}")
        for step, got, want in diffs:
            say("parity", kernel=kernel, step=step, ours=got, golden=want)
        require(match or max_rel <= FIDELITY_MAX_REL,
                f"parity {kernel}: max rel err {max_rel:.3e} > "
                f"{FIDELITY_MAX_REL}")


def phase_exact() -> None:
    import jax

    from nbody_tpu.config import SimConfig
    from nbody_tpu.init import make_state
    from nbody_tpu.ops import naive, pallas_kernel
    from nbody_tpu.ops.registry import resolve
    from nbody_tpu.simulation import run

    rng = np.random.default_rng(42)
    for n, tol in KERNEL_TOL.items():
        st = make_state(n)
        idx = np.sort(rng.choice(n, KERNEL_SAMPLES, replace=False))
        ref = accel64(st.pos, st.mass, idx)
        pallas_fn = jax.jit(pallas_kernel.accelerations)
        t0 = time.perf_counter()
        a_pl = np.asarray(pallas_fn(st.pos, st.mass))[:, idx]
        t_pl = time.perf_counter() - t0
        # naive's full self-sweep at 1M costs seconds; the between form
        # on the sampled targets runs the same per-target sum.
        a_nv = np.asarray(jax.jit(naive.accelerations_between)(
            st.pos[:, idx], st.pos, st.mass))
        e_pl, e_nv = rel_err(a_pl, ref), rel_err(a_nv, ref)
        say("exact", n=n, samples=KERNEL_SAMPLES,
            pallas_rel_err=f"{e_pl:.3e}", naive_rel_err=f"{e_nv:.3e}",
            tol=tol, pallas_first_call_s=f"{t_pl:.2f}")
        require(e_pl <= tol, f"pallas N={n}: {e_pl:.3e} > {tol}")
        require(e_nv <= tol, f"naive N={n}: {e_nv:.3e} > {tol}")

    n = ENGINE_N
    res = run(SimConfig(n=n, nsteps=4, sfreq=2, kernel="auto"), quiet=True)
    kes = [ke for (_, _, ke, _, _) in res.samples]
    say("exact", engine_n=n, kernel="auto", resolved=resolve("auto"),
        steps=4, sfreq=2, ms_per_step=f"{ms_per_step(res, 2):.1f}",
        kenergy=f"{kes[-1]:.6g}", idle_share="not measured")
    require(len(kes) == 2 and all(map(math.isfinite, kes)),
            f"engine N={n}: kinetic energy trace {kes}")


def phase_mesh() -> None:
    import jax

    from nbody_tpu.config import SimConfig
    from nbody_tpu.init import make_state
    from nbody_tpu.ops import naive, pm
    from nbody_tpu.simulation import run

    # p3m accuracy on a clustered state.
    n = P3M_N
    st = make_state(n, distribution="plummer")
    idx = np.sort(np.random.default_rng(7).choice(n, P3M_SAMPLES,
                                                  replace=False))
    a_ref = np.asarray(jax.jit(naive.accelerations_between)(
        st.pos[:, idx], st.pos, st.mass))
    grid, cut = pm.DEFAULT_GRID, pm.DEFAULT_CUTOFF_CELLS
    for name, cap in (
        ("measured", pm.suggest_capacity(st.pos, st.mass, grid, cut,
                                         max_capacity=1 << 20)),
        ("default", 0),
    ):
        plan = pm.suggest_sr_plan(st.pos, st.mass, grid, cut, capacity=cap)
        over = float(pm.cell_overflow_fraction(st.pos, st.mass, grid, cut,
                                               plan["capacity"]))
        a_p3m = jax.jit(lambda p, m: pm.p3m_accelerations(p, m, **plan))(
            st.pos, st.mass)
        err = rel_err(np.asarray(a_p3m)[:, idx], a_ref)
        say("mesh", kernel="p3m", distribution="plummer", n=n,
            capacity_plan=name, samples=P3M_SAMPLES,
            force_rel_err=f"{err:.3e}", cell_overflow=f"{over:.3f}",
            tol=P3M_PLUMMER_TOL if name == "measured" else "reported",
            **plan)
        if name == "measured":
            require(over == 0.0, f"p3m plummer: overflow {over}")
            require(err <= P3M_PLUMMER_TOL, f"p3m plummer: {err:.3e}")

    st = make_state(ENGINE_N)
    idx = np.sort(np.random.default_rng(7).choice(ENGINE_N, P3M_SAMPLES,
                                                  replace=False))
    a_ref = np.asarray(jax.jit(naive.accelerations_between)(
        st.pos[:, idx], st.pos, st.mass))
    a_pm = jax.jit(pm.accelerations)(st.pos, st.mass)
    err = rel_err(np.asarray(a_pm)[:, idx], a_ref)
    say("mesh", kernel="pm", distribution="reference", n=ENGINE_N,
        grid=pm.DEFAULT_GRID, samples=P3M_SAMPLES,
        force_rel_err=f"{err:.3e}", tol=PM_TOL)
    require(err <= PM_TOL, f"pm reference: {err:.3e}")

    cases = (
        ("p3m", dict(n=n, kernel="p3m", distribution="plummer", dt=0.01)),
        ("pm", dict(n=ENGINE_N, kernel="pm")),
        ("p3m-periodic", dict(n=ENGINE_N, kernel="p3m",
                              pm_boundary="periodic", pm_box=1.0)),
    )
    for name, kw in cases:
        runs = [run(SimConfig(nsteps=4, sfreq=2, **kw), quiet=True)
                for _ in range(2)]
        kes = [[ke for (_, _, ke, _, _) in r.samples] for r in runs]
        rep = max(abs(a - b) / abs(b) for a, b in zip(*kes))
        say("mesh", run=name, n=kw["n"], steps=4,
            ms_per_step=f"{ms_per_step(runs[1], 2):.1f}",
            kenergy=f"{kes[1][-1]:.6g}", run_to_run_rel=f"{rep:.2e}",
            tol=MESH_REPEAT_TOL)
        require(all(math.isfinite(k) for ks in kes for k in ks),
                f"mesh {name}: non-finite kinetic energy {kes}")
        require(rep <= MESH_REPEAT_TOL, f"mesh {name}: run to run {rep}")


def phase_multi(shards: int) -> None:
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    n = ENGINE_N
    cases = (
        ("exact", "auto", "ring"),
        ("exact", "auto", "allgather"),
        ("p3m", "p3m", "allgather"),
    )
    single = {}
    for kind, kernel, comm in cases:
        kw = dict(n=n, nsteps=2, sfreq=2, kernel=kernel)
        if kernel not in single:
            single[kernel] = run(SimConfig(**kw), quiet=True)
        one = single[kernel]
        many = run(SimConfig(shards=shards, comm=comm, **kw), quiet=True)
        ke1, ke4 = one.samples[-1][2], many.samples[-1][2]
        rel = abs(ke4 - ke1) / abs(ke1)
        tol = MULTI_TOL[kind]
        say("multi", kernel=kernel, comm=comm, n=n, shards=shards,
            ms_per_step=f"{ms_per_step(many, 2):.1f}",
            one_card_ms_per_step=f"{ms_per_step(one, 2):.1f}",
            kenergy_rel_vs_one_card=f"{rel:.2e}", tol=tol)
        require(math.isfinite(ke4) and rel <= tol,
                f"multi {kernel}/{comm}: {rel:.2e} > {tol}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the 4-card sharded phase")
    args = p.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX's default device is "
              f"{devs[0].platform}", file=sys.stderr)
        return 2
    if args.multi and len(devs) < 4:
        print(f"chip_smoke --multi: needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    from nbody_tpu.utils.platform import enable_compilation_cache

    phase_device(enable_compilation_cache())
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(4)
    else:
        phase_parity()
        phase_exact()
        phase_mesh()
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
