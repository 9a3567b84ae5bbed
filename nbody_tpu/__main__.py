"""CLI entry point.

Positional-argument compatible with the reference binaries:
    python -m nbody_tpu [N] [nsteps] [device] [cpu_ratio] [dim0 dim1]
(ver0/main.cpp:25-46; extended form ver5_all/main.cpp:23-66: the device
token is echoed to stdout, cpu_ratio is accepted for CLI parity, and the
thread dims map onto kernel tile sizes).

Runtime options replace the reference's compile-time #define matrix:
    --kernel {naive,pallas,pm,p3m,auto}  force-kernel backend (ARCH=
                                   analog); pallas = tiled GPU pair
                                   kernel; pm = O(N log N) mesh solver
                                   (--pm-grid), approximate; p3m = pm +
                                   exact short-range correction
                                   (--pm-cutoff/--pm-capacity), accurate
                                   on clustered distributions
    --precision {f32,bf16,ref64}   numeric mode (ref64 = bit-exact oracle)
    --integrator {euler,leapfrog}  parity default / symplectic option
    --shards K --comm {allgather,ring}  GSPMD particle decomposition
    --tile-i/--tile-j/--autotune   Pallas tile selection
    --distribution/--seed          initial-condition families
    --save-state/--load-state/--snapshot-*   checkpointing & trajectories
    --platform cpu / --interpret   host execution of any path
    --profile-dir DIR              dump a jax.profiler trace
"""

from __future__ import annotations

import argparse
import sys

from .config import SimConfig
from .simulation import Simulation


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody_tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"nbody-tpu {__version__}")
    p.add_argument("n", nargs="?", type=int, default=2000)
    p.add_argument("nsteps", nargs="?", type=int, default=500)
    p.add_argument("device", nargs="?", default=None,
                   help="cpu|gpu|cpu+gpu (reference CLI parity)")
    p.add_argument("cpu_ratio", nargs="?", type=float, default=None)
    p.add_argument("dim0", nargs="?", type=int, default=0)
    p.add_argument("dim1", nargs="?", type=int, default=0)
    p.add_argument("--kernel", default="auto",
                   choices=["naive", "pallas", "pm", "p3m", "auto"])
    p.add_argument("--pm-grid", type=int, default=0, metavar="NG",
                   help="particle-mesh grid points per axis for "
                        "--kernel pm/p3m (default 128; O(N log N) "
                        "approximate far-field tier)")
    p.add_argument("--pm-cutoff", type=int, default=0, metavar="A",
                   help="P3M short-range split radius in grid spacings "
                        "(default 4 for --kernel p3m; the accuracy knob: "
                        "error ~ A^-3, short-range cost ~ A^3)")
    p.add_argument("--pm-capacity", type=int, default=0, metavar="C",
                   help="P3M cell-list slots per cell (default: sized "
                        "from the initial state's max cell occupancy; "
                        "overflowing cells fall back to mesh-quality "
                        "forces)")
    p.add_argument("--pm-boundary", default="open",
                   choices=["open", "periodic"],
                   help="mesh-solver boundary: open = isolated system in "
                        "vacuum (adaptive box; default), periodic = fixed "
                        "cubic box, forces of all images minus the uniform "
                        "background (the cosmological convention; "
                        "--kernel pm or p3m)")
    p.add_argument("--pm-box", type=float, default=0.0, metavar="L",
                   help="periodic box edge for --pm-boundary periodic "
                        "(positions are wrapped into [0, L))")
    p.add_argument("--pm-replan", action="store_true",
                   help="re-measure the P3M short-range plan mid-run "
                        "when the per-sample-block health check finds "
                        "cell/ghost overflow on the evolved state "
                        "(grow-only; rebuilds+recompiles the blocks). "
                        "Default: warn once and keep the t=0 plan")
    p.add_argument("--precision", default="f32",
                   choices=["f32", "bf16", "ref64"])
    p.add_argument("--tile-i", type=int, default=0)
    p.add_argument("--tile-j", type=int, default=0)
    p.add_argument("--autotune", action="store_true",
                   help="on-device tile-size sweep before the run")
    p.add_argument("--autotune-online", action="store_true",
                   help="retune tiles during the run, one candidate per "
                        "sample block (the OpenCL backend's per-block "
                        "tuner analog)")
    p.add_argument("--interpret", action="store_true",
                   help="run the Pallas kernel in interpreter mode (debug / "
                        "exercise the pallas path on CPU)")
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--comm", default="allgather",
                   choices=["allgather", "ring"],
                   help="sharded source exchange: XLA all-gather or XLA "
                        "ppermute ring")
    p.add_argument("--sfreq", type=int, default=50)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--integrator", default="euler",
                   choices=["euler", "leapfrog"],
                   help="euler = reference parity; leapfrog = symplectic")
    p.add_argument("--distribution", default="reference",
                   choices=["reference", "plummer", "cold_sphere"],
                   help="initial conditions (reference = bit-exact parity)")
    p.add_argument("--seed", type=int, default=42,
                   help="IC seed (the reference hard-codes 42)")
    p.add_argument("--energy-check", action="store_true",
                   help="report total-energy (KE+PE) drift at the end")
    p.add_argument("--platform", default=None)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--save-state", default=None, metavar="PATH",
                   help="write final (and periodic) state checkpoints here")
    p.add_argument("--load-state", default=None, metavar="PATH",
                   help="resume from a checkpoint instead of fresh init")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="also checkpoint every K-th sample block")
    p.add_argument("--checkpoint-backend", default="npz",
                   choices=["npz", "orbax"])
    p.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                   help="dump full state every K-th sample block")
    p.add_argument("--snapshot-dir", default=None, metavar="DIR")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the run result as JSON ('-' = stdout)")
    p.add_argument("--list-devices", action="store_true",
                   help="print visible accelerators and exit (the OpenCL "
                        "backend's device-discovery analog)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.platform import enable_compilation_cache

    enable_compilation_cache()
    if args.list_devices:
        import jax

        for d in jax.devices():
            print(f"{d.id}: {d.platform} {d.device_kind}")
        try:
            for d in jax.local_devices(backend="cpu"):
                print(f"{d.id}: cpu {d.device_kind}")
        except RuntimeError:
            pass
        return 0
    if args.platform == "cpu" or args.device == "cpu":
        import os

        from .utils.platform import force_cpu

        # In a multi-process run each process hosts only its share of the
        # virtual devices (the global mesh is assembled by jax.distributed).
        nprocs = int(
            os.environ.get("JAX_NUM_PROCESSES")
            or os.environ.get("NBODY_NUM_PROCESSES")
            or 1
        )
        nprocs = max(1, nprocs)
        if args.shards > 1 and args.shards % nprocs:
            raise SystemExit(
                f"--shards {args.shards} must be divisible by the process "
                f"count {nprocs} (each process hosts shards/nprocs devices)"
            )
        local = max(1, args.shards // nprocs)
        force_cpu(local if args.shards > 1 else None)
    cfg = SimConfig(
        n=args.n, nsteps=args.nsteps, dt=args.dt, sfreq=args.sfreq,
        integrator=args.integrator, distribution=args.distribution,
        seed=args.seed, energy_check=args.energy_check,
        kernel=args.kernel, tile_i=args.tile_i or args.dim0,
        tile_j=args.tile_j or args.dim1, pm_grid=args.pm_grid,
        pm_cutoff=args.pm_cutoff, pm_capacity=args.pm_capacity,
        pm_boundary=args.pm_boundary, pm_box=args.pm_box,
        pm_replan=args.pm_replan,
        autotune=args.autotune,
        autotune_online=args.autotune_online,
        interpret=args.interpret,
        precision=args.precision,
        shards=args.shards, comm=args.comm,
        platform=args.platform or ("cpu" if args.device == "cpu" else None),
        profile_dir=args.profile_dir, debug_nans=args.debug_nans,
        save_state_path=args.save_state, load_state_path=args.load_state,
        checkpoint_every=args.checkpoint_every,
        checkpoint_backend=args.checkpoint_backend,
        snapshot_every=args.snapshot_every, snapshot_dir=args.snapshot_dir,
    )
    sim = Simulation(cfg)
    # Establish rank/size FIRST so the echo and the cpu_ratio note below
    # are rank-0-gated under multi-process runs (the reference gates all
    # output on world_rank == 0, ver5_all/GSimulation.cpp:119).
    sim.init_mpi()  # no-op single-host (ver5_all/main.cpp:57 analog)
    if args.device is not None:
        # The reference echoes the token then maps it onto the device
        # selector (ver5_all/main.cpp:42-45: cpu=1, gpu=2, cpu+gpu=3).
        if sim.world_rank == 0:
            print(args.device)
        selector = {"cpu": 1, "gpu": 2, "cpu+gpu": 3}.get(args.device)
        if selector is not None:
            sim.set_devices(selector)
    if args.cpu_ratio is not None:
        sim.set_cpu_ratio(args.cpu_ratio)
    result = sim.start()
    if args.json:
        import json

        payload = json.dumps(result.to_dict(), indent=1)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
