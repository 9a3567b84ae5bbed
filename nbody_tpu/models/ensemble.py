"""Batched ensembles of independent simulations — `jax.vmap` over the
sample block.

A capability the reference architecture cannot express: its per-run
state is a heap-allocated ``GSimulation`` object stepped by nested loops
(ver0/GSimulation.cpp:95-173), so E independent runs are E process
launches.  Here a sample block is a pure function of a ``ParticleState``
pytree, so an ensemble is ONE transformed function: ``vmap`` adds the
member axis, XLA fuses the batch into the same kernels (the pair sweep
becomes one (E·pairs) schedule, the mesh tier one batched FFT), and one
jit/dispatch steps every member.  Use cases: seed/IC parameter sweeps,
uncertainty ensembles, and batch serving of many small systems where
per-run dispatch overhead would dominate.

Scaling: members are embarrassingly parallel, so sharding the ENSEMBLE
axis over a device mesh needs no collectives at all — pass ``mesh`` to
place members across devices (data parallelism over runs; contrast the
particle-sharded axis in ``parallel/decompose.py`` which trades
collectives for single-system size).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..state import ParticleState
from .gravity import make_block_fn


def stack_states(states: Sequence[ParticleState]) -> ParticleState:
    """Stack E same-shape member states into one ensemble state with a
    leading member axis on every array leaf: pos/vel (E, 3, N),
    mass (E, N).  ``n`` is static pytree metadata and must agree."""
    if not states:
        raise ValueError("stack_states needs at least one member state")
    n = states[0].n
    npad = states[0].n_padded
    for s in states[1:]:
        if s.n != n or s.n_padded != npad:
            raise ValueError(
                f"ensemble members must share (n, n_padded); got "
                f"({s.n}, {s.n_padded}) vs ({n}, {npad})"
            )
    return ParticleState(
        pos=jnp.stack([s.pos for s in states]),
        vel=jnp.stack([s.vel for s in states]),
        mass=jnp.stack([s.mass for s in states]),
        n=n,
    )


def member(state: ParticleState, i: int) -> ParticleState:
    """Extract member ``i`` of an ensemble state."""
    e = state.pos.shape[0]
    if not -e <= i < e:
        # jnp integer indexing CLAMPS out-of-bounds — a wrong E would
        # silently duplicate the last member instead of erroring.
        raise IndexError(f"member {i} out of range for ensemble of {e}")
    return ParticleState(pos=state.pos[i], vel=state.vel[i],
                         mass=state.mass[i], n=state.n)


def make_ensemble_block_fn(
    accel_fn: Callable,
    dt: float,
    steps: int,
    integrator: str = "euler",
    mesh: Optional[jax.sharding.Mesh] = None,
    axis: Optional[str] = None,
) -> Callable:
    """Jitted ensemble sample block: (ensemble ParticleState) ->
    (ensemble ParticleState, per-member KE (E,)).

    ``accel_fn`` is any single-system registry kernel binding
    (``gravity.make_accel_fn``) — every kernel family vmaps, including
    the Pallas sweeps (batch grid dimension) and the mesh tiers
    (batched FFTs).  With ``mesh``, the member axis is split via
    ``shard_map`` so each device runs its E/K members WHOLE — no
    collectives, and no reliance on GSPMD auto-partitioning the member
    programs (it cannot split an FFT or a Pallas kernel without
    inserting all-gathers; whole-member placement sidesteps that
    entirely).  E must divide the mesh size."""
    blk = make_block_fn(accel_fn, dt, steps, integrator=integrator)
    vblk = jax.vmap(blk)
    if mesh is None:
        return jax.jit(vblk)

    from jax.sharding import PartitionSpec as P

    ax = axis or mesh.axis_names[0]
    k = mesh.shape[ax]
    spec = P(ax)
    jitted_by_n: dict = {}

    def _build(n: int):
        def local_members(pos, vel, mass):
            # Runs per device on its local slice of the member axis;
            # the ParticleState is rebuilt inside (shard_map specs are
            # per-array, and n is static metadata).
            out, ke = vblk(ParticleState(pos=pos, vel=vel, mass=mass,
                                         n=n))
            return out.pos, out.vel, out.mass, ke

        # Pallas calls carry no varying-mesh-axes metadata; disable the
        # replication checker.
        smf = jax.shard_map(local_members, mesh=mesh, check_vma=False,
                            in_specs=(spec, spec, spec),
                            out_specs=(spec, spec, spec, spec))
        return jax.jit(smf)

    def run(ens: ParticleState):
        e = ens.pos.shape[0]
        if e % k:
            raise ValueError(
                f"ensemble size {e} must divide over the {k}-device "
                f"mesh axis {ax!r} (whole members per device)"
            )
        if ens.n not in jitted_by_n:
            jitted_by_n[ens.n] = _build(ens.n)
        pos, vel, mass, ke = jitted_by_n[ens.n](
            ens.pos, ens.vel, ens.mass)
        return ParticleState(pos=pos, vel=vel, mass=mass, n=ens.n), ke

    # For the HLO-inspection path (tests): expose a lower() analog.
    def lower(ens: ParticleState):
        if ens.n not in jitted_by_n:
            jitted_by_n[ens.n] = _build(ens.n)
        return jitted_by_n[ens.n].lower(ens.pos, ens.vel, ens.mass)

    run.lower = lower
    return run
