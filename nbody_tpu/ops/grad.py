"""Analytic VJP for the all-pairs force kernel, making the Pallas path
differentiable (XLA cannot autodiff through pallas_call).

With a_i = sum_j G m_j f(p_j - p_i),  f(r) = r (|r|^2 + eps)^(-3/2):

  J(r) = df/dr = s I - 3 u^(-5/2) r r^T,   u = |r|^2 + eps,  s = u^(-3/2)

  dL/dp_k = G m_k sum_i J(r_ik) g_i  -  sum_j G m_j J(r_kj) g_k
  dL/dm_k = G sum_i g_i . f(p_k - p_i)

where g is the output cotangent.  Both terms are pair sums with the same
distance geometry as the forward kernel; they are evaluated here as one
chunked jnp sweep (XLA-fused, O(chunk*N) memory), which is itself
differentiable, so higher-order derivatives fall out of autodiff.  The
i==k diagonal appears identically in both position terms and cancels
exactly, so it is left unmasked — consistent with the forward kernel's unmasked diagonal
(ver0/GSimulation.cpp:132-147).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import G_NEWTON, SOFTENING_SQUARED
from .naive import _largest_divisor_leq


def force_vjp(pos: jax.Array, mass: jax.Array, g: jax.Array,
              chunk: int = 1024) -> tuple[jax.Array, jax.Array]:
    """Cotangents (d_pos, d_mass) of the self-acceleration kernel.

    pos (3,N) f32, mass (N,), g (3,N) cotangent of acc -> ((3,N), (N,))."""
    n = pos.shape[1]
    f32 = jnp.float32
    gm = (mass * f32(G_NEWTON)).astype(f32)
    eps2 = f32(SOFTENING_SQUARED)
    c = _largest_divisor_leq(n, chunk)

    def block(args):
        pos_k, g_k, gm_k = args  # (3,c), (3,c), (c,)
        # r[a, kc, j] = pos[a, j] - pos_k[a, kc]
        r = pos[:, None, :] - pos_k[:, :, None]  # (3, c, N)
        u = r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + eps2  # (c, N)
        inv = jax.lax.rsqrt(u)
        s = inv * inv * inv  # u^-3/2
        q = f32(3.0) * s * (inv * inv)  # 3 u^-5/2

        # term A: G m_k * sum_j J(r_kj) g_j   (uses J's symmetry in r)
        rg = r[0] * g[0][None, :] + r[1] * g[1][None, :] + r[2] * g[2][None, :]
        a_term = jnp.stack(
            [
                jnp.sum(s * g[a][None, :] - q * rg * r[a], axis=1)
                for a in range(3)
            ]
        ) * gm_k[None, :]  # (3, c)

        # term B: sum_j G m_j J(r_kj) g_k
        rgk = (
            r[0] * g_k[0][:, None]
            + r[1] * g_k[1][:, None]
            + r[2] * g_k[2][:, None]
        )  # (c, N)
        w = gm[None, :]
        b_term = jnp.stack(
            [
                jnp.sum(w * (s * g_k[a][:, None] - q * rgk * r[a]), axis=1)
                for a in range(3)
            ]
        )  # (3, c)

        # d_mass: G * sum_i g_i . f(p_k - p_i) — note f(p_k - p_i) = -f(r_ki),
        # and r here is r[.,k,i] = p_i - p_k, so f(p_k - p_i) = -r * s.
        dm = -jnp.sum(rg * s, axis=1) * f32(G_NEWTON)  # (c,)
        return a_term - b_term, dm

    blocks = (
        pos.reshape(3, n // c, c).transpose(1, 0, 2),
        g.reshape(3, n // c, c).transpose(1, 0, 2),
        gm.reshape(n // c, c),
    )
    d_pos, d_mass = jax.lax.map(block, blocks)
    return (
        d_pos.transpose(1, 0, 2).reshape(3, n),
        d_mass.reshape(n),
    )


def differentiable(accel_fn, chunk: int = 1024):
    """Wrap a (pos, mass) -> acc kernel with the analytic custom VJP
    (``force_vjp``), which also makes the Pallas kernel differentiable
    (XLA cannot autodiff through ``pallas_call``)."""

    @jax.custom_vjp
    def accel(pos, mass):
        return accel_fn(pos, mass)

    def fwd(pos, mass):
        return accel_fn(pos, mass), (pos, mass)

    def bwd(res, g):
        pos, mass = res
        return force_vjp(pos, mass, g, chunk=chunk)

    accel.defvjp(fwd, bwd)
    return accel
