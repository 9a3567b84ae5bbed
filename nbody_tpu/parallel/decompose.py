"""GSPMD particle decomposition — the replacement for the reference's MPI
layer (ver5_all/GSimulation.cpp:93-214).

The reference's distributed step is replicated-state/partitioned-compute:
rank 0 broadcasts all nine state arrays every step (``mpi_bcast_all``
:170-189), each rank computes accelerations for its i-slice
(cpu/Compute.cpp:47-58), and a Gatherv collects slices back (:191-214).
Here state is *persistently sharded* over the particle axis of a 1-D mesh
and never round-trips through a root:

* ``comm='allgather'`` — each shard all-gathers positions+masses once per
  step and computes forces for its local i-slice (the Bcast analog, but
  peer-to-peer — NCCL over NVLink on a GPU host — and fused into the
  jitted step).
* ``comm='ring'``      — positions stay sharded; a K-1-hop ``ppermute``
  ring streams each source block through every shard while the pair
  kernel consumes the previous block, so per-shard working memory is
  O(N/K) and comm overlaps compute (the scalable path; SURVEY.md §2.4).

Zero-mass padding makes every shard equal-sized, sidestepping the
reference's broken ``n % world_size`` remainder handling
(cpu/Compute.cpp:50-51 vs GSimulation.cpp:198-201).

The kinetic-energy diagnostic is a local reduction + ``psum`` (the
Gatherv analog, collapsed to a scalar).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import ParticleState
from .mesh import AXIS, make_mesh


def state_specs() -> ParticleState:
    """PartitionSpecs for a particle-sharded ParticleState."""
    return ParticleState(
        pos=P(None, AXIS), vel=P(None, AXIS), mass=P(AXIS), n=0
    )


def shard_state(
    state: ParticleState, shards: int, mesh: Mesh = None
) -> Tuple[ParticleState, Mesh]:
    """Place a (padded) state onto a ``shards``-device mesh, particle-sharded."""
    if mesh is None:
        mesh = make_mesh(shards)
    if state.n_padded % shards:
        raise ValueError(
            f"padded count {state.n_padded} not divisible by {shards} shards"
        )
    specs = state_specs()

    def put(x, spec):
        sharding = NamedSharding(mesh, spec)
        if jax.process_count() > 1:
            # Multi-process mesh: device_put accepts only host (or
            # uncommitted) data for non-addressable shardings.  State
            # construction is deterministic, so every process holds the
            # same full array — the replicated-input contract.
            import numpy as np

            x = np.asarray(x)
        return jax.device_put(x, sharding)

    sharded = ParticleState(
        pos=put(state.pos, specs.pos),
        vel=put(state.vel, specs.vel),
        mass=put(state.mass, specs.mass),
        n=state.n,
    )
    return sharded, mesh


def _accel_allgather(between_fn, pos_l, mass_l):
    pos_all = lax.all_gather(pos_l, AXIS, axis=1, tiled=True)
    mass_all = lax.all_gather(mass_l, AXIS, axis=0, tiled=True)
    return between_fn(pos_l, pos_all, mass_all)


def _accel_ring(between_fn, pos_l, mass_l):
    """Ring-streamed sources: K-1 ppermute hops, compute on the in-hand
    block while the next hop is in flight (XLA overlaps the async
    collective with the pair kernel)."""
    k = lax.axis_size(AXIS)
    perm = [(i, (i + 1) % k) for i in range(k)]
    buf = jnp.concatenate([pos_l, mass_l[None, :]], axis=0)  # (4, Nl)
    acc = between_fn(pos_l, buf[0:3], buf[3])
    for _ in range(k - 1):
        buf = lax.ppermute(buf, AXIS, perm)
        acc = acc + between_fn(pos_l, buf[0:3], buf[3])
    return acc


_ACCEL_MODES = {"allgather": _accel_allgather, "ring": _accel_ring}


def make_sharded_block_fn(kernel_name: str, kernel_opts: dict, dt: float,
                          block_steps: int, mesh: Mesh, comm: str = "allgather",
                          integrator: str = "euler"):
    """Jitted sample block over a particle-sharded state: advances
    ``block_steps`` steps fully on device and returns (state, kenergy)."""
    from ..models.integrators import INTEGRATORS
    from ..ops import registry

    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")

    if kernel_name in ("pm", "p3m") and comm != "allgather":
        # The mesh solver needs every target inside the source box; the
        # ring streams source BLOCKS whose bounding boxes do not cover
        # remote targets.
        raise ValueError(
            f"--kernel {kernel_name} supports only --comm allgather "
            "when sharded"
        )

    if kernel_name in ("pm", "p3m"):
        # Mesh-kernel decomposition: despite the flag name, positions are
        # NOT all-gathered — each shard deposits its local sources and
        # ONE lax.psum reduces the mass grid (pm.sharded_accelerations;
        # per-shard deposit/gather work O(N/K)).  P3M's short-range pass
        # is the one consumer that still gathers sources (index sharding
        # is not spatial).
        from ..ops import pm as pm_ops

        # Keep the measured SR plan (sr_slabs/sr_entries): without it
        # sharded p3m falls back to the 2^22-capped default bound and
        # silently drops worklist entries on clustered N >~ 1M.
        popts = {
            key: v
            for key, v in kernel_opts.items()
            if key in ("grid", "cutoff_cells", "capacity",
                       "sr_slabs", "sr_entries", "sr_ghosts",
                       "boundary", "box_size")
        }
        if kernel_name == "p3m":
            popts.setdefault("cutoff_cells", pm_ops.DEFAULT_CUTOFF_CELLS)

        def make_env(p, m):
            # Per-block frozen box + spectra (the sharded analog of the
            # engine's single-device mesh_env — keeps both paths'
            # traces aligned and drops per-step box collectives).
            return pm_ops.make_mesh_env_sharded(
                p, m, AXIS,
                grid=popts.get("grid", pm_ops.DEFAULT_GRID),
                cutoff_cells=popts.get("cutoff_cells", 0),
                boundary=popts.get("boundary", "open"),
                box_size=popts.get("box_size", 0.0))

        def accel_local(p, m, env=None):
            return pm_ops.sharded_accelerations(p, m, AXIS,
                                                mesh_env=env, **popts)

    else:
        between_fn = registry.get_between(kernel_name)
        if kernel_opts:
            between_fn = functools.partial(between_fn, **kernel_opts)
        try:
            accel_mode = _ACCEL_MODES[comm]
        except KeyError:
            raise ValueError(
                f"unknown comm mode {comm!r}; options: "
                f"{sorted(_ACCEL_MODES)}"
            ) from None

        make_env = None

        def accel_local(p, m, env=None):
            return accel_mode(between_fn, p, m)

    dtf = jnp.float32(dt)
    half = jnp.float32(0.5) * dtf

    def _steps(pos, vel, mass, env):
        if integrator == "euler":

            def step(_, carry):
                p, v = carry
                acc = accel_local(p, mass, env)
                v = v + acc * dtf
                p = p + v * dtf
                return (p, v)

            pos, vel = lax.fori_loop(0, block_steps, step, (pos, vel))
        else:  # leapfrog (kick-drift-kick, acceleration carried)
            acc0 = accel_local(pos, mass, env)

            def step(_, carry):
                p, v, acc = carry
                v_h = v + acc * half
                p = p + v_h * dtf
                acc_n = accel_local(p, mass, env)
                return (p, v_h + acc_n * half, acc_n)

            pos, vel, _ = lax.fori_loop(0, block_steps, step, (pos, vel, acc0))

        v2 = vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]
        ke = lax.psum(jnp.float32(0.5) * jnp.sum(mass * v2), AXIS)
        return pos, vel, ke

    def block(pos, vel, mass):
        env = make_env(pos, mass) if make_env is not None else None
        return _steps(pos, vel, mass, env)

    # Pallas calls carry no varying-mesh-axes metadata; disable the
    # replication checker.
    sharded = jax.shard_map(
        block, mesh=mesh, check_vma=False,
        in_specs=(P(None, AXIS), P(None, AXIS), P(AXIS)),
        out_specs=(P(None, AXIS), P(None, AXIS), P()),
    )
    jitted = jax.jit(sharded)

    def run(state: ParticleState):
        pos, vel, ke = jitted(state.pos, state.vel, state.mass)
        return (ParticleState(pos=pos, vel=vel, mass=state.mass,
                              n=state.n), ke)

    return run
