"""Integrators.

The reference has exactly one: semi-implicit Euler
(ver0/GSimulation.cpp:153-161), kept as the default for parity.  The
kick-drift-kick leapfrog is an extension: symplectic (bounded
energy error instead of Euler's secular drift) at the same one force
evaluation per step, with the acceleration carried through the fused
sample-block loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..state import ParticleState
from .gravity import AccelFn, kinetic_energy

INTEGRATORS = ("euler", "leapfrog")


def make_block_fn(accel_fn: AccelFn, dt: float, block_steps: int,
                  integrator: str = "euler", env_fn=None):
    """Jitted sample block: advances block_steps steps on device, returns
    (state, kinetic_energy).

    ``env_fn(pos, mass) -> pytree`` computes a per-BLOCK environment
    once at block entry (inside the jit, before the step loop) that is
    then passed to every step as ``accel_fn(pos, mass, env)`` — the
    mesh solvers use it to freeze the robust box + force-kernel
    spectra across a sample block (ops/pm.make_mesh_env), turning
    per-step transforms into per-block ones."""
    dtf = jnp.float32(dt)

    if env_fn is None:
        def call(pos, mass, _env):
            return accel_fn(pos, mass)
    else:
        def call(pos, mass, env):
            return accel_fn(pos, mass, mesh_env=env)

    if integrator == "euler":

        @jax.jit
        def block(state: ParticleState):
            env = env_fn(state.pos, state.mass) if env_fn else None

            def body(_, st: ParticleState) -> ParticleState:
                acc = call(st.pos, st.mass, env)
                vel = st.vel + acc * dtf
                pos = st.pos + vel * dtf
                return ParticleState(pos=pos, vel=vel, mass=st.mass, n=st.n)

            state = lax.fori_loop(0, block_steps, body, state)
            return state, kinetic_energy(state)

        return block

    if integrator == "leapfrog":
        half = jnp.float32(0.5) * dtf

        @jax.jit
        def block(state: ParticleState):
            env = env_fn(state.pos, state.mass) if env_fn else None
            # One extra force evaluation per block re-seeds the carried
            # acceleration (state holds no acc between blocks).
            acc0 = call(state.pos, state.mass, env)

            def body(_, carry):
                st, acc = carry
                vel_h = st.vel + acc * half          # kick
                pos = st.pos + vel_h * dtf           # drift
                acc_n = call(pos, st.mass, env)
                vel = vel_h + acc_n * half           # kick
                return (
                    ParticleState(pos=pos, vel=vel, mass=st.mass, n=st.n),
                    acc_n,
                )

            state, _ = lax.fori_loop(0, block_steps, body, (state, acc0))
            return state, kinetic_energy(state)

        return block

    raise ValueError(f"unknown integrator {integrator!r}; options: {INTEGRATORS}")
