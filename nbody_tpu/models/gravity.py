"""The gravity model: semi-implicit Euler stepping + kinetic-energy
diagnostic, fused into a single on-device sample block.

Reference semantics (ver0/GSimulation.cpp:153-173):
  vel += acc * dt;  pos += vel_new * dt;  KE = 0.5 * sum(m * |v|^2)

The reference's offload backends copy positions/accelerations across the
host-device boundary every step and integrate on the host
(ver5_all/programming_models/cuda/Compute.cu:147-189).  Here the entire
sample block (sfreq steps, ver0/GSimulation.cpp:31 default 50) runs on
device inside one jitted ``lax.fori_loop``; the host syncs once per block
to print diagnostics — that sync is the only host<->device traffic.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..state import ParticleState

AccelFn = Callable[[jax.Array, jax.Array], jax.Array]


def kinetic_energy(state: ParticleState) -> jax.Array:
    """KE = 0.5 * sum_i m_i |v_i|^2 (ver0/GSimulation.cpp:167-173).
    Zero-mass padding particles contribute exactly zero."""
    v = state.vel
    v2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    return jnp.float32(0.5) * jnp.sum(state.mass * v2)


def euler_step(state: ParticleState, accel_fn: AccelFn, dt: float) -> ParticleState:
    """One semi-implicit Euler step (ver0/GSimulation.cpp:153-161)."""
    dtf = jnp.float32(dt)
    acc = accel_fn(state.pos, state.mass)
    vel = state.vel + acc * dtf
    pos = state.pos + vel * dtf
    return ParticleState(pos=pos, vel=vel, mass=state.mass, n=state.n)


def make_block_fn(accel_fn: AccelFn, dt: float, block_steps: int,
                  integrator: str = "euler", env_fn=None):
    """Build a jitted function advancing ``block_steps`` steps on device and
    returning (new_state, kinetic_energy_after_last_step).  ``env_fn``
    computes a per-block environment fed to accel_fn as ``mesh_env=``
    (see integrators.make_block_fn)."""
    from .integrators import make_block_fn as _mk

    return _mk(accel_fn, dt, block_steps, integrator=integrator,
               env_fn=env_fn)


def potential_energy(state: ParticleState, chunk: int = 1024) -> jax.Array:
    """Softened potential energy, consistent with the force law:
    PE = -(G/2) sum_i sum_j m_i m_j (|r_ij|^2 + eps)^(-1/2).

    Includes the i==j self term, which is a constant (-G m^2 / (2 sqrt(eps))
    per particle) and therefore irrelevant to conservation diagnostics; the
    reference likewise never masks the diagonal.  KE + PE is the conserved
    energy of the softened system (the reference prints only KE)."""
    from ..ops.naive import _largest_divisor_leq
    from ..types import G_NEWTON, SOFTENING_SQUARED

    pos, mass = state.pos, state.mass
    n = pos.shape[1]
    c = _largest_divisor_leq(n, chunk)
    eps2 = jnp.float32(SOFTENING_SQUARED)

    def block(args):
        pos_i, m_i = args  # (3, c), (c,)
        d = pos[:, None, :] - pos_i[:, :, None]  # (3, c, N)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + eps2
        inv = jax.lax.rsqrt(d2)  # (c, N)
        return jnp.sum((m_i[:, None] * mass[None, :]) * inv)

    blocks = (
        pos.reshape(3, n // c, c).transpose(1, 0, 2),
        mass.reshape(n // c, c),
    )
    total = jnp.sum(jax.lax.map(block, blocks))
    return jnp.float32(-0.5 * G_NEWTON) * total


def make_accel_fn(kernel_name: str, differentiable: bool = False,
                  **opts) -> AccelFn:
    """Bind a registry kernel with its options into the AccelFn signature.

    ``differentiable=True`` attaches the analytic custom VJP (ops/grad.py),
    required to differentiate through the Pallas kernel and cheaper than
    XLA autodiff for the naive one.

    The mesh tiers differentiate NATIVELY instead: the exact-pair
    analytic VJP would silently return all-pairs cotangents for a mesh
    forward.  pm is reverse-differentiable as-is; p3m gets the
    static-bound sweep (ops/pm.py ``differentiable=True``)."""
    from ..ops import registry

    fn = registry.get(kernel_name)
    if kernel_name in ("pm", "p3m"):
        if differentiable:
            opts = dict(opts, differentiable=True)
        return functools.partial(fn, **opts) if opts else fn
    if opts:
        fn = functools.partial(fn, **opts)
    if differentiable:
        from ..ops.grad import differentiable as _diff

        fn = _diff(fn)
    return fn
