"""The simulation engine — GSimulation analog.

Owns the run lifecycle the reference's ``GSimulation::start()`` owns
(ver0/GSimulation.cpp:95-213): allocate + initialize state, print the
header, run the sample-block loop with per-block timing and GFlop/s stats,
print the footer.  Differences are deliberate accelerator-first design:

* the entire sample block (sfreq steps) is one jitted on-device
  ``lax.fori_loop``; the host syncs once per block (the reference's GPU
  backends instead cross PCIe six times per step,
  ver5_all/programming_models/cuda/Compute.cu:152-166);
* compilation happens ahead-of-time, before the clock starts;
* ``precision='ref64'`` routes through the bit-exact host oracle so the
  printed kenergy column reproduces the compiled C++ reference exactly.

The GFlop/s statistics replicate the reference's: per-block
``gflops*sfreq/block_seconds`` with running mean/stddev that exclude the
first two sample blocks (ver0/GSimulation.cpp:186-203).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import jax
import numpy as np

from .config import SimConfig
from .init import make_state, reference_init_arrays
from .models.gravity import make_accel_fn, make_block_fn
from .state import ParticleState
from .utils import reporting
from .utils.flops import step_gflops
from .utils.timer import WallTime


@dataclasses.dataclass
class RunResult:
    samples: List[Tuple[int, float, float, float, float]]
    # each: (step, phys_time, kenergy, block_seconds, block_gflops)
    total_time: float
    av: float
    dev: float
    nthreads: int
    energy_drift: Optional[float] = None  # set when energy_check is on
    start_step: int = 0  # non-zero when resumed from a checkpoint

    @property
    def kenergy_trace(self) -> List[Tuple[int, float]]:
        return [(s, ke) for (s, _, ke, _, _) in self.samples]

    def to_dict(self) -> dict:
        return dict(
            samples=[
                dict(step=s, t_phys=t, kenergy=ke, seconds=b, gflops=g)
                for (s, t, ke, b, g) in self.samples
            ],
            total_time=self.total_time,
            gflops_mean=self.av,
            gflops_dev=self.dev,
            nthreads=self.nthreads,
            energy_drift=self.energy_drift,
            start_step=self.start_step,
        )


class _BlockRunner:
    """Produces (state, kenergy) per sample block; pluggable per precision."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        # Absolute step the run starts at (non-zero when resuming, so the
        # printed step column and saved checkpoints stay on the absolute
        # counter across chained resumes — checkpoint.py's contract).
        self.start_step = 0

    def prepare(self) -> None:  # compile / allocate before the clock starts
        raise NotImplementedError

    def run_block(self, steps: int) -> float:  # returns kenergy, advances state
        raise NotImplementedError

    def observe(self, block_secs: float) -> None:
        """Feedback hook after each full sample block (online retuning)."""

    def save(self, path: str, step: int) -> None:
        raise NotImplementedError

    def total_energy(self) -> float:
        raise NotImplementedError


class _DeviceRunner(_BlockRunner):
    def __init__(self, cfg: SimConfig):
        super().__init__(cfg)
        self.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())
        self.state: Optional[ParticleState] = None
        self._blocks = {}
        self._sr_health = False  # per-block P3M plan health check
        self._sr_warned = False

    def save(self, path: str, step: int) -> None:
        if self.cfg.checkpoint_backend == "orbax":
            from .utils.checkpoint import save_state_orbax

            save_state_orbax(path, self.state, step)
        else:
            from .utils.checkpoint import save_state

            save_state(path, self.state, step)

    def prepare(self) -> None:
        cfg = self.cfg
        if cfg.load_state_path:
            from .utils.checkpoint import load_state

            state, self.start_step = load_state(
                cfg.load_state_path, cfg.pad_multiple()
            )
            cfg.n = state.n
        else:
            state = make_state(
                cfg.n,
                pad_multiple=cfg.pad_multiple(),
                distribution=cfg.distribution,
                seed=cfg.seed,
            )
        if cfg.platform and cfg.shards <= 1:
            # Sharded runs place state themselves (shard_state); committing
            # to one device first would block multi-process device_put.
            dev = jax.local_devices(backend=cfg.platform)[0]
            state = jax.device_put(state, dev)
        from .ops.registry import resolve

        ddt = "bfloat16" if cfg.precision == "bf16" else "float32"
        resolved = resolve(cfg.kernel)
        if resolved == "p3m" or (resolved == "pm" and cfg.pm_cutoff):
            # The P3M cell capacity and short-range plan (slab/worklist
            # sizes) are static shapes under jit, so they cannot follow
            # the data inside the compiled block — size them here from
            # the CONCRETE initial state (clustered cores make occupancy
            # wildly data-dependent; pm.suggest_sr_plan).
            cfg.resolve_sr_plan(state.pos, state.mass)
            self._sr_health = cfg.nsteps > 0
            self.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())
        tunable = resolved == "pallas"
        if cfg.autotune and tunable and not (cfg.tile_i and cfg.tile_j):
            from .utils.autotune import autotune_tiles

            cfg.tile_i, cfg.tile_j = autotune_tiles(
                state.n_padded // cfg.shards, dist_dtype=ddt,
                interpret=cfg.interpret,
            )
            self.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())
        self._online = None
        # The online retuner (the reference's tuner ran unconditionally
        # every sample block, opencl/Compute.cpp:317-321) covers the tiled
        # kernel, single-device and sharded alike.
        if (
            cfg.autotune_online and tunable and cfg.nsteps > 0
            and not (cfg.tile_i and cfg.tile_j)
        ):
            from .utils.autotune import DEFAULT_CANDIDATES

            self._online = dict(cands=list(DEFAULT_CANDIDATES), idx=0,
                                results=[], warmed=False, locked=False,
                                retried=False)
            self._set_tiles(self._online["cands"][0])
        if cfg.shards > 1:
            from .parallel.decompose import shard_state, make_sharded_block_fn

            state, mesh = shard_state(state, cfg.shards)
            self._block_for = lambda steps: self._cached(
                steps,
                lambda: make_sharded_block_fn(
                    cfg.kernel, cfg.kernel_opts(), cfg.dt, steps, mesh,
                    comm=cfg.comm, integrator=cfg.integrator,
                ),
            )
        else:
            env_fn = self._mesh_env_fn(resolved)
            self._block_for = lambda steps: self._cached(
                steps,
                lambda: make_block_fn(
                    self.accel_fn, cfg.dt, steps,
                    integrator=cfg.integrator, env_fn=env_fn,
                ),
            )
        self.state = state
        # Warm-up call (compiles and runs one block, result discarded) so
        # the timed loop never pays compilation; state is immutable so the
        # warm-up does not advance the simulation.
        while True:
            try:
                main = self._block_for(min(cfg.sfreq, cfg.nsteps))
                _, ke = main(state)
                float(ke)
                break
            except Exception as e:  # noqa: BLE001 — see _candidate_failed
                self._candidate_failed(e)  # re-raises unless retuning

    def _mesh_env_fn(self, resolved):
        """Per-block frozen mesh environment builder (pm.make_mesh_env):
        robust box + force-kernel spectra computed once per sample block
        instead of every step.  None for non-mesh kernels.

        None for PERIODIC mesh runs too: the open env pays off because
        its spectra depend on the per-step robust BOX, but periodic
        spectra are position-independent constants — XLA already hoists
        their in-trace build out of the block's fori_loop, while a
        frozen env would cross the executable boundary as ~100 MB of
        complex inputs every block.  pm.make_mesh_env still builds
        periodic envs for callers that trace the env INSIDE their own
        executable (the sharded block)."""
        if resolved not in ("pm", "p3m"):
            return None
        from .ops import pm as pm_ops

        ko = self.cfg.kernel_opts()
        if ko.get("boundary", "open") == "periodic":
            return None
        cutoff = ko.get("cutoff_cells", 0)
        if resolved == "p3m":
            cutoff = cutoff or pm_ops.DEFAULT_CUTOFF_CELLS
        kw = dict(grid=ko.get("grid", pm_ops.DEFAULT_GRID),
                  cutoff_cells=cutoff,
                  boundary=ko.get("boundary", "open"),
                  box_size=ko.get("box_size", 0.0))
        return lambda pos, mass: pm_ops.make_mesh_env(pos, mass, **kw)

    def _cached(self, steps: int, build: Callable):
        # Keyed by tiles too: the online retuner switches tile configs
        # between sample blocks.
        key = (steps, self.cfg.tile_i, self.cfg.tile_j)
        if key not in self._blocks:
            self._blocks[key] = build()
        return self._blocks[key]

    def _set_tiles(self, tiles) -> None:
        self.cfg.tile_i, self.cfg.tile_j = tiles
        self.accel_fn = make_accel_fn(self.cfg.kernel, **self.cfg.kernel_opts())

    def _discard_candidate(self) -> None:
        """Drop the online retuner's current candidate (it failed to
        compile or run — e.g. tiles that need more registers or shared
        memory than a block may have) and move to the next, or lock in
        the best-so-far."""
        ol = self._online
        del ol["cands"][ol["idx"]]
        ol["warmed"] = False
        ol["retried"] = False
        if ol["idx"] < len(ol["cands"]):
            self._set_tiles(ol["cands"][ol["idx"]])
        else:
            ol["locked"] = True
            self._set_tiles(min(ol["results"])[1] if ol["results"] else (0, 0))

    def _candidate_failed(self, exc: Exception) -> None:
        """Failure policy while the online retuner is active.  A
        transient backend error must not be pinned on the current tile
        candidate, and real bugs must not be silently swallowed: each
        candidate gets ONE retry, and a discard is logged with the
        triggering exception.  Outside retuning (or after lock-in) the
        exception propagates."""
        ol = self._online
        if not ol or ol["locked"]:
            raise exc
        if not ol["retried"]:
            ol["retried"] = True
            return
        import sys

        print(
            f"# autotune-online: discarding tiles {ol['cands'][ol['idx']]} "
            f"after two failures ({type(exc).__name__}: {exc})",
            file=sys.stderr,
        )
        self._discard_candidate()

    # Cell-overflow fraction above which the t=0 P3M plan is declared
    # degraded (overflowed particles fall back to mesh-quality forces —
    # accuracy decays toward pure PM for those pairs).
    SR_HEALTH_MAX_OVERFLOW = 0.005

    def _check_sr_health(self) -> None:
        """Per-sample-block P3M plan health: the static plan was sized
        from the t=0 state (resolve_sr_plan), but clustering EVOLVES —
        a collapse run overflows a plan that was exact at start without
        any error.  Check the overflow diagnostics on the CURRENT state
        and either warn once (default) or, under --pm-replan,
        re-measure the plan and rebuild the blocks.  Replanning only
        ever GROWS the static shapes (max with current), so a run
        recompiles at most a handful of times as structure forms."""
        cfg = self.cfg
        if not self._sr_health:
            return
        from .ops import pm

        grid = cfg.pm_grid or pm.DEFAULT_GRID
        cutoff = cfg.pm_cutoff or pm.DEFAULT_CUTOFF_CELLS
        frac = float(pm.cell_overflow_fraction(
            self.state.pos, self.state.mass, grid, cutoff,
            cfg.pm_capacity, boundary=cfg.pm_boundary,
            box_size=cfg.pm_box))
        ghosts = 0
        if cfg.pm_boundary == "periodic":
            ghosts = pm.ghost_overflow_count(
                self.state.pos, self.state.mass, grid, cutoff,
                sr_ghosts=cfg.pm_sr_ghosts, box_size=cfg.pm_box)
        # Worklist entry overflow: the runtime guard that makes
        # per-layout plan sizing safe (suggest_sr_plan sizes sr_entries
        # for the ACTIVE layout only; dropped entries silently lose
        # their whole short-range correction, so any overflow is
        # degradation — no fraction threshold).
        entries = pm.sr_entry_overflow(
            self.state.pos, self.state.mass, grid, cutoff,
            capacity=cfg.pm_capacity, sr_slabs=cfg.pm_sr_slabs,
            sr_entries=cfg.pm_sr_entries, boundary=cfg.pm_boundary,
            box_size=cfg.pm_box)
        if (frac <= self.SR_HEALTH_MAX_OVERFLOW and not ghosts
                and not entries):
            return
        import sys

        # Multi-process runs: every rank computes the diagnostics (and
        # replans — cfg mutations must stay rank-identical for the
        # rebuilt shard_map blocks to agree), but only rank 0 narrates
        # (the reference gates all output on world_rank 0,
        # ver5_all/GSimulation.cpp:119).
        def _say(msg):
            if jax.process_index() == 0:
                print(msg, file=sys.stderr)

        detail = (f"cell overflow {frac:.1%}"
                  + (f", {ghosts} ghost images dropped" if ghosts
                     else "")
                  + (f", {entries} worklist entries dropped" if entries
                     else ""))
        if not cfg.pm_replan:
            if not self._sr_warned:
                self._sr_warned = True
                _say(
                    f"# p3m plan health: {detail} on the current state "
                    "— the t=0 plan no longer fits (accuracy degrades "
                    "toward pure PM for the overflowed pairs"
                    + (";\n# dropped ghosts lose their short-range term "
                       "entirely" if ghosts else "")
                    + (";\n# dropped worklist entries lose their "
                       "short-range term entirely" if entries else "")
                    + ").  Rerun with --pm-replan to re-measure "
                    "mid-run, or raise --pm-capacity."
                )
            return
        plan = pm.suggest_sr_plan(
            self.state.pos, self.state.mass, grid, cutoff,
            boundary=cfg.pm_boundary, box_size=cfg.pm_box)
        cap = max(cfg.pm_capacity, plan["capacity"])
        if cap != plan["capacity"]:
            # S/E must be measured at the capacity the rebuilt blocks
            # will actually bin with (a bigger cap bins MORE particles
            # -> more slabs/entries); sizing them at a smaller measured
            # cap would silently starve the worklist — the exact
            # failure suggest_sr_plan's docstring warns about.
            plan = pm.suggest_sr_plan(
                self.state.pos, self.state.mass, grid, cutoff,
                capacity=cap, boundary=cfg.pm_boundary,
                box_size=cfg.pm_box)
        grown = dict(
            pm_capacity=max(cfg.pm_capacity, plan["capacity"]),
            pm_sr_slabs=max(cfg.pm_sr_slabs, plan["sr_slabs"]),
            pm_sr_entries=max(cfg.pm_sr_entries, plan["sr_entries"]),
            pm_sr_ghosts=max(cfg.pm_sr_ghosts,
                             plan.get("sr_ghosts", 0)),
        )
        if all(grown[k] == getattr(cfg, k) for k in grown):
            # The measured plan cannot grow past the current one (e.g.
            # ghost churn inside the suggested headroom): nothing to
            # rebuild, and re-suggesting every block would thrash.
            if not self._sr_warned:
                self._sr_warned = True
                _say(
                    f"# p3m plan health: {detail}, but a re-measured "
                    "plan is no larger than the current one — raise "
                    "--pm-capacity explicitly if this persists."
                )
            return
        for k, v in grown.items():
            setattr(cfg, k, v)
        self._sr_warned = False  # a future degradation re-reports
        _say(
            f"# p3m plan health: {detail} — replanned to "
            f"capacity={cfg.pm_capacity} slabs={cfg.pm_sr_slabs} "
            f"entries={cfg.pm_sr_entries}"
            + (f" ghosts={cfg.pm_sr_ghosts}"
               if cfg.pm_boundary == "periodic" else "")
            + " (blocks rebuild on next sample block)"
        )
        self._blocks.clear()
        self.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())

    def observe(self, block_secs: float) -> None:
        """Online per-block retuning (the reference's OpenCL tuner adjusts
        its work split every sample block, opencl/Compute.cpp:317-321).
        Each candidate gets one warm-up block (absorbs its compile) and
        one timed block; after the last candidate the best is locked."""
        self._check_sr_health()
        ol = self._online
        if not ol or ol["locked"]:
            return
        if not ol["warmed"]:
            ol["warmed"] = True  # compile/warm-up block — discard timing
            return
        ol["results"].append((block_secs, ol["cands"][ol["idx"]]))
        ol["idx"] += 1
        ol["warmed"] = False
        ol["retried"] = False
        if ol["idx"] < len(ol["cands"]):
            self._set_tiles(ol["cands"][ol["idx"]])
        else:
            ol["locked"] = True
            self._set_tiles(min(ol["results"])[1])

    def run_block(self, steps: int) -> float:
        while True:
            try:
                fn = self._block_for(steps)
                state, ke = fn(self.state)
                # float() forces a device->host fetch of the block's final
                # kinetic energy — the once-per-block sync point (ver0 reads
                # _kenergy on the host every step; our block runs sfreq
                # steps between syncs).  The fetch is also where device
                # failures surface, so it stays inside the retry.
                ke = float(ke)
            except Exception as e:  # noqa: BLE001 — see _candidate_failed
                # A failure during online retuning: state never advanced,
                # so retry/skip the candidate and rerun the block (the
                # policy — one retry, logged discard — lives in
                # _candidate_failed; outside retuning it re-raises).
                self._candidate_failed(e)
                continue
            self.state = state
            return ke

    def total_energy(self) -> float:
        from .models.gravity import kinetic_energy, potential_energy

        if self.cfg.pm_boundary == "periodic":
            # The open pairwise PE is meaningless under periodic
            # boundaries (the image sum diverges); use the mesh-solved
            # background-subtracted PE — same definition at t=0 and
            # t=end, which is all a drift diagnostic needs.
            from .ops.pm import DEFAULT_GRID, periodic_potential_energy

            pe = float(periodic_potential_energy(
                self.state.pos, self.state.mass, self.cfg.pm_box,
                self.cfg.pm_grid or DEFAULT_GRID))
            return float(kinetic_energy(self.state)) + pe
        return float(kinetic_energy(self.state)) + float(
            potential_energy(self.state)
        )


class _OracleRunner(_BlockRunner):
    """Bit-exact ver0-semantics host runner (see oracle.py)."""

    def prepare(self) -> None:
        if self.cfg.load_state_path:
            from .utils.checkpoint import load_state

            state, self.start_step = load_state(self.cfg.load_state_path)
            self.pos = np.asarray(state.pos)
            self.vel = np.asarray(state.vel)
            self.mass = np.asarray(state.mass)
            self.cfg.n = state.n
        else:
            self.pos, self.vel, self.mass = reference_init_arrays(self.cfg.n)
        self.ke = np.float32(0.0)

    def save(self, path: str, step: int) -> None:
        from .state import pad_state
        from .utils.checkpoint import save_state

        st = pad_state(self.pos, self.vel, self.mass, self.pos.shape[1])
        save_state(path, st, step)

    def run_block(self, steps: int) -> float:
        from .oracle import step_ref64

        for _ in range(steps):
            self.pos, self.vel, self.ke = step_ref64(
                self.pos, self.vel, self.mass, self.cfg.dt
            )
        return float(self.ke)

    def total_energy(self) -> float:
        import jax.numpy as jnp

        from .models.gravity import kinetic_energy, potential_energy
        from .state import ParticleState

        st = ParticleState(
            pos=jnp.asarray(self.pos), vel=jnp.asarray(self.vel),
            mass=jnp.asarray(self.mass), n=self.pos.shape[1],
        )
        return float(kinetic_energy(st)) + float(potential_energy(st))


def run(cfg: SimConfig, out=None, quiet: bool = False) -> RunResult:
    runner: _BlockRunner
    if cfg.precision == "ref64":
        runner = _OracleRunner(cfg)
    else:
        runner = _DeviceRunner(cfg)
    return _run_prepared(runner, cfg, out, quiet)


def _run_prepared(runner: _BlockRunner, cfg: SimConfig, out,
                  quiet: bool) -> RunResult:
    emit = (lambda *_: None) if quiet else reporting.emit

    if cfg.debug_nans:
        jax.config.update("jax_debug_nans", True)

    runner.prepare()
    # Absolute step offset: 0 on fresh runs, the checkpoint's step counter
    # on resume, so printed steps / saved checkpoints continue the counter.
    step0 = runner.start_step

    e0 = runner.total_energy() if cfg.energy_check else None

    emit(reporting.header(cfg.n, cfg.nsteps, cfg.dt), out)

    gflops = step_gflops(cfg.n)
    timer = WallTime()
    samples: List[Tuple[int, float, float, float, float]] = []
    av = 0.0
    dev = 0.0
    nf = 0

    profile_ctx = None
    if cfg.profile_dir:
        profile_ctx = jax.profiler.trace(cfg.profile_dir)
        profile_ctx.__enter__()

    t0 = timer.start()
    s = 0
    while s < cfg.nsteps:
        steps = min(cfg.sfreq, cfg.nsteps - s)
        b0 = timer.start()
        ke = runner.run_block(steps)
        b1 = timer.stop()
        s += steps
        if steps == cfg.sfreq and s % cfg.sfreq == 0:
            nf += 1
            block_secs = b1 - b0
            block_gf = gflops * cfg.sfreq / block_secs
            t_phys = float(np.float32(step0 + s) * np.float32(cfg.dt))
            samples.append((step0 + s, t_phys, ke, block_secs, block_gf))
            emit(
                reporting.stats_row(step0 + s, t_phys, ke, block_secs, block_gf),
                out,
            )
            runner.observe(block_secs)
            if nf > 2:
                av += block_gf
                dev += block_gf * block_gf
            if (
                cfg.checkpoint_every
                and cfg.save_state_path
                and nf % cfg.checkpoint_every == 0
            ):
                runner.save(cfg.save_state_path, step0 + s)
            if (
                cfg.snapshot_every
                and cfg.snapshot_dir
                and nf % cfg.snapshot_every == 0
            ):
                import os

                os.makedirs(cfg.snapshot_dir, exist_ok=True)
                runner.save(
                    os.path.join(cfg.snapshot_dir, f"step_{step0 + s:06d}.npz"),
                    step0 + s,
                )
    t1 = timer.stop()

    if cfg.save_state_path:
        runner.save(cfg.save_state_path, step0 + cfg.nsteps)

    if profile_ctx:
        profile_ctx.__exit__(None, None, None)

    total = t1 - t0
    if nf > 2:
        av /= nf - 2
        dev = math.sqrt(max(dev / (nf - 2) - av * av, 0.0))
    else:
        av = dev = float("nan")

    nthreads = cfg.shards if cfg.shards > 1 else 1
    emit(reporting.footer(nthreads, total, av, dev), out)
    result = RunResult(samples, total, av, dev, nthreads, start_step=step0)
    if cfg.energy_check and e0 is not None:
        e1 = runner.total_energy()
        drift = abs(e1 - e0) / max(abs(e0), 1e-30)
        result.energy_drift = drift
        emit(f"# Energy drift |dE/E|: {drift:.3e} "
             f"(E0={e0:.6g}, E1={e1:.6g})", out)
    return result


class Simulation:
    """Class-style facade mirroring the reference's GSimulation public API
    (ver0/GSimulation.hpp:36-80; ver5_all/GSimulation.hpp:40-65)."""

    def __init__(self, config: Optional[SimConfig] = None, quiet: bool = False):
        self.config = config or SimConfig()
        self._quiet = quiet
        self.world_rank = 0  # ver5_all/GSimulation.hpp:60-61 equivalents
        self.world_size = 1
        # The banner is deferred until the rank is known (init_mpi) or the
        # run starts: printing it here would emit it on every rank of a
        # multi-process run, whereas the reference gates all output on
        # world_rank == 0 (ver5_all/GSimulation.cpp:119).
        self._banner_printed = False
        self.result: Optional[RunResult] = None

    def _print_banner_once(self) -> None:
        if not self._banner_printed and not self._quiet and self.world_rank == 0:
            reporting.print_banner()
        self._banner_printed = True

    def init_mpi(self) -> None:
        """Multi-host bootstrap — the reference's ``init_mpi()``
        (ver5_all/GSimulation.cpp:93-115).  On a single host this is a
        no-op; in a multi-process environment (coordinator address in
        the environment) it initializes jax.distributed and records
        rank/size.  Non-zero ranks print nothing (the reference gates
        output on world_rank == 0, ver5_all/GSimulation.cpp:119)."""
        import os

        if not (
            os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS")
            or int(os.environ.get("NBODY_NUM_PROCESSES", "1")) > 1
        ):
            self._print_banner_once()
            return
        from .parallel.distributed import init_distributed

        self.world_rank, self.world_size = init_distributed()
        if self.world_rank != 0:
            self._quiet = True
        self._print_banner_once()

    def set_number_of_particles(self, n: int) -> None:
        self.config.n = n

    def set_number_of_steps(self, nsteps: int) -> None:
        self.config.nsteps = nsteps

    # ver5_all extensions (ver5_all/GSimulation.hpp:51-58).  CPU/GPU work
    # ratios are meaningless on a homogeneous device mesh; thread dims map
    # onto kernel tile sizes; the device selector keeps its reference
    # semantics (1=cpu, 2=gpu-class accelerator, 3=split -> accelerator).
    def set_devices(self, n: int) -> None:
        self._devices = n
        if n == 1:
            self.config.platform = "cpu"
        elif n in (2, 3):
            self.config.platform = None

    def set_cpu_ratio(self, ratio: float) -> None:
        """ver5_all CLI parity (main.cpp:49).  The OpenCL backend splits
        each step's work between CPU and GPU by this ratio
        (opencl/Compute.cpp:241-255); a device mesh is homogeneous, so
        there is nothing to split — the value is recorded and a note is emitted
        rather than the flag being silently inert."""
        import sys

        self._cpu_ratio = ratio
        if not self._quiet and self.world_rank == 0:
            print(
                f"# cpu_ratio={ratio:g} noted: device meshes are homogeneous; "
                "work is split evenly across shards (no CPU/GPU "
                "co-execution to tune)",
                file=sys.stderr,
            )

    def set_thread_dim0(self, d: int) -> None:
        if d > 0:
            self.config.tile_i = d

    def set_thread_dim1(self, d: int) -> None:
        if d > 0:
            self.config.tile_j = d

    def start(self) -> RunResult:
        self._print_banner_once()  # single-host path without init_mpi()
        self.result = run(self.config, quiet=self._quiet)
        return self.result
