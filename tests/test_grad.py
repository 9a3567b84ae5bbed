"""Differentiability: the analytic custom VJP must match XLA autodiff of
the naive kernel, and make the Pallas kernel differentiable."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nbody_tpu.init import reference_init_arrays
from nbody_tpu.models.gravity import make_accel_fn
from nbody_tpu.ops import naive
from nbody_tpu.ops.grad import differentiable, force_vjp


@pytest.fixture(scope="module")
def system():
    pos, vel, mass = reference_init_arrays(256)
    return jnp.asarray(pos), jnp.asarray(mass)


def _loss_fn(accel):
    def loss(pos, mass):
        a = accel(pos, mass)
        return jnp.sum(a * a) * jnp.float32(1e20)  # scale into fp32 range

    return loss


def test_custom_vjp_matches_autodiff(system):
    pos, mass = system
    auto = jax.grad(_loss_fn(naive.accelerations), argnums=(0, 1))(pos, mass)
    custom = jax.grad(
        _loss_fn(differentiable(naive.accelerations)), argnums=(0, 1)
    )(pos, mass)
    for got, want in zip(custom, auto):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < 1e-4, err


@pytest.mark.parametrize("tiles", [(32, 32), (64, 32), (32, 128)])
def test_pallas_kernel_differentiable(system, tiles):
    """The custom VJP over the tiled kernel (interpret mode) against
    XLA autodiff of naive."""
    pos, mass = system
    accel_p = make_accel_fn(
        "pallas", differentiable=True, tile_i=tiles[0], tile_j=tiles[1],
        interpret=True
    )
    auto = jax.grad(_loss_fn(naive.accelerations), argnums=(0, 1))(pos, mass)
    got = jax.grad(_loss_fn(accel_p), argnums=(0, 1))(pos, mass)
    for g, w in zip(got, auto):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err < 1e-3, err


def test_grad_through_trajectory(system):
    # Differentiate a 5-step rollout w.r.t. initial velocities — the
    # use-case (fitting initial conditions) the custom VJP enables.
    pos, mass = system
    accel = make_accel_fn("naive", differentiable=True)
    dt = jnp.float32(0.1)

    def rollout(vel):
        p, v = pos, vel
        for _ in range(5):
            a = accel(p, mass)
            v = v + a * dt
            p = p + v * dt
        return jnp.sum(p[0]) * jnp.float32(1.0)

    g = jax.grad(rollout)(jnp.zeros_like(pos))
    assert np.all(np.isfinite(np.asarray(g)))
    # dp_x/dv_x after k steps is k*dt for every particle (leading order in
    # the weak-force regime); check the structure is right.
    assert np.allclose(np.asarray(g[0]), 0.5, atol=0.01)
    assert np.allclose(np.asarray(g[1]), 0.0, atol=0.01)


def test_vjp_zero_cotangent(system):
    pos, mass = system
    d_pos, d_mass = force_vjp(pos, mass, jnp.zeros_like(pos))
    assert np.all(np.asarray(d_pos) == 0)
    assert np.all(np.asarray(d_mass) == 0)
