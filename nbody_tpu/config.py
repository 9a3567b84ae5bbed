"""Run configuration.

Replaces the reference's positional-argv + compile-time #define matrix
(SIMD/ASALIGN/USE_MPI/... across ver*/Makefile and ver5_all/Makefile:1-100)
with one dataclass.  Defaults mirror the reference ctor
(ver0/GSimulation.cpp:24-32): N=2000, 500 steps, dt=0.1, sample freq 50.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SimConfig:
    n: int = 2000
    nsteps: int = 500
    dt: float = 0.1
    sfreq: int = 50
    integrator: str = "euler"  # euler (reference parity) | leapfrog
    distribution: str = "reference"  # | plummer | cold_sphere
    seed: int = 42  # the reference hard-codes 42 (ver0/GSimulation.cpp:47)
    energy_check: bool = False  # report total-energy drift (KE+PE) at end

    # Kernel selection (the ver5_all ARCH= backend seam, runtime-switchable).
    kernel: str = "auto"  # naive | pallas | pm | p3m | auto
    tile_i: int = 0  # 0 = kernel default
    tile_j: int = 0
    pm_grid: int = 0  # particle-mesh grid per axis (0 = kernel default)
    pm_cutoff: int = 0  # P3M split radius in grid spacings (0 = kernel
    # default: off for pm, ops/pm.DEFAULT_CUTOFF_CELLS for p3m; the
    # accuracy knob — error ~ cutoff^-3, short-range cost ~ cutoff^3)
    pm_capacity: int = 0  # P3M cell-list slots per cell (0 = data-driven
    # at block build via pm.suggest_sr_plan)
    pm_sr_slabs: int = 0  # P3M short-range table slabs (0 = data-driven
    # at block build / guaranteed bound; pm.suggest_sr_plan)
    pm_sr_entries: int = 0  # P3M worklist entries (0 = same)
    pm_sr_ghosts: int = 0  # periodic-P3M ghost-image slots (0 = same)
    pm_boundary: str = "open"  # open (vacuum, adaptive box) | periodic
    # (fixed cubic box; forces of all images minus the uniform
    # background — the cosmological convention; ops/pm.py "Periodic-box
    # boundary mode")
    pm_box: float = 0.0  # periodic box edge (required > 0 for periodic;
    # positions are wrapped into [0, pm_box) inside the solver)
    pm_replan: bool = False  # re-measure the P3M plan mid-run when the
    # per-sample-block health check (cell/ghost overflow on the CURRENT
    # state) crosses threshold, growing the static plan and rebuilding
    # the blocks (recompiles!).  Off = warn once instead; the t=0 plan
    # stays (overflow degrades toward mesh-quality forces, never worse)
    autotune: bool = False  # on-device tile sweep (OpenCL autotune analog)
    autotune_online: bool = False  # per-sample-block retune DURING the run
    # (the reference's opencl tuner adjusts its split every sample block,
    # opencl/Compute.cpp:317-321; here each candidate tiling gets a
    # warm-up block plus a timed block, then the best is locked in)
    interpret: bool = False  # run the Pallas kernel in interpreter mode
    # (debug / CPU execution of the pallas path)
    precision: str = "f32"  # f32 | bf16 | ref64 (bit-exact host oracle)

    # Parallelism (the USE_MPI axis, as GSPMD sharding).
    shards: int = 1
    comm: str = "allgather"  # allgather | ring

    # Placement: None = default accelerator; "cpu" pins to host backend.
    platform: Optional[str] = None

    # Diagnostics.
    profile_dir: Optional[str] = None
    debug_nans: bool = False

    # Checkpoint / resume (no reference analog; SURVEY.md §5).
    save_state_path: Optional[str] = None  # write final state here
    load_state_path: Optional[str] = None  # start from this checkpoint
    checkpoint_every: int = 0  # also save every k-th sample block
    checkpoint_backend: str = "npz"  # npz | orbax (see utils/checkpoint.py)

    # Trajectory snapshots: full state every k-th sample block into
    # snapshot_dir/step_NNNNNN.npz (no reference analog).
    snapshot_every: int = 0
    snapshot_dir: Optional[str] = None

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.nsteps < 0:
            raise ValueError(f"nsteps must be >= 0, got {self.nsteps}")
        if self.sfreq < 1:
            raise ValueError(f"sfreq must be >= 1, got {self.sfreq}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        from .types import PRECISIONS

        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; options: {PRECISIONS}"
            )
        if self.pm_boundary not in ("open", "periodic"):
            raise ValueError(
                f"unknown pm boundary {self.pm_boundary!r}; options: "
                "'open', 'periodic'"
            )
        if self.pm_boundary == "periodic":
            if self.kernel not in ("pm", "p3m"):
                raise ValueError(
                    "--pm-boundary periodic is a mesh-solver mode; it "
                    "requires --kernel pm or p3m"
                )
            if self.pm_box <= 0:
                raise ValueError(
                    "--pm-boundary periodic requires --pm-box L > 0 (the "
                    "fixed cubic box edge)"
                )
            if self.precision == "ref64":
                # ref64 dispatches to the ver0-semantics host oracle,
                # which simulates OPEN-boundary all-pairs physics (and
                # the divergent open pairwise PE) — it would silently
                # ignore the box the user asked for.
                raise ValueError(
                    "--pm-boundary periodic is incompatible with "
                    "--precision ref64 (the host oracle is the "
                    "open-boundary ver0 replica; it has no periodic "
                    "mode)"
                )
        elif self.pm_box:
            raise ValueError("--pm-box only applies to --pm-boundary "
                             "periodic")
        if self.pm_replan and not (
            self.kernel == "p3m"
            or (self.kernel == "pm" and self.pm_cutoff)
        ):
            raise ValueError(
                "--pm-replan re-measures the P3M short-range plan; it "
                "requires --kernel p3m (or --kernel pm with "
                "--pm-cutoff > 0)"
            )
        if self.kernel in ("pm", "p3m") and self.precision == "bf16":
            # The mesh solver is fp32-only; silently running fp32 while
            # reporting bf16 would misrepresent the configuration.
            raise ValueError(
                f"--kernel {self.kernel} is fp32-only; it does not support "
                "--precision bf16 (use --kernel pallas for the bf16 "
                "distance mode)"
            )

    def resolve_sr_plan(self, pos, mass) -> bool:
        """Fill the P3M static-plan fields (capacity / sr_slabs /
        sr_entries / sr_ghosts) from the CONCRETE state via
        pm.suggest_sr_plan, unless every applicable field is already
        pinned.  The plan is a static shape under jit — clustered cores
        make cell occupancy wildly data-dependent, so both the engine
        and bench measure it on the real initial positions.  Returns
        True when this config has a short-range pass (p3m, or pm with
        a cutoff), False otherwise (nothing to size)."""
        from .ops.registry import resolve

        resolved = resolve(self.kernel)
        if not (resolved == "p3m"
                or (resolved == "pm" and self.pm_cutoff)):
            return False
        periodic = self.pm_boundary == "periodic"
        if (self.pm_capacity and self.pm_sr_slabs and self.pm_sr_entries
                and (self.pm_sr_ghosts or not periodic)):
            return True
        from .ops.pm import (
            DEFAULT_CUTOFF_CELLS,
            DEFAULT_GRID,
            suggest_sr_plan,
        )

        plan = suggest_sr_plan(
            pos, mass,
            self.pm_grid or DEFAULT_GRID,
            self.pm_cutoff or DEFAULT_CUTOFF_CELLS,
            capacity=self.pm_capacity,
            boundary=self.pm_boundary, box_size=self.pm_box,
        )
        self.pm_capacity = plan["capacity"]
        self.pm_sr_slabs = self.pm_sr_slabs or plan["sr_slabs"]
        self.pm_sr_entries = self.pm_sr_entries or plan["sr_entries"]
        if periodic:
            self.pm_sr_ghosts = self.pm_sr_ghosts or plan["sr_ghosts"]
        return True

    def kernel_opts(self) -> dict:
        from .ops.registry import resolve

        resolved = resolve(self.kernel)
        opts = {}
        if resolved == "pallas":
            if self.tile_i:
                opts["tile_i"] = self.tile_i
            if self.tile_j:
                opts["tile_j"] = self.tile_j
            if self.interpret:
                opts["interpret"] = True
        if resolved in ("pm", "p3m"):
            if self.pm_grid:
                opts["grid"] = self.pm_grid
            if self.pm_cutoff:
                opts["cutoff_cells"] = self.pm_cutoff
            if self.pm_capacity:
                opts["capacity"] = self.pm_capacity
            if self.pm_sr_slabs:
                opts["sr_slabs"] = self.pm_sr_slabs
            if self.pm_sr_entries:
                opts["sr_entries"] = self.pm_sr_entries
            if self.pm_sr_ghosts:
                opts["sr_ghosts"] = self.pm_sr_ghosts
            if self.pm_boundary != "open":
                opts["boundary"] = self.pm_boundary
                opts["box_size"] = self.pm_box
        if self.precision == "bf16":
            if resolved in ("pm", "p3m"):  # post-construction mutation path
                raise ValueError(
                    f"--kernel {resolved} is fp32-only (no bf16 mode)"
                )
            opts["dist_dtype"] = "bfloat16"
        return opts

    def pad_multiple(self) -> int:
        """Particle-count padding needed by sharding (every kernel pads
        its own tiles inside)."""
        return max(1, self.shards)
