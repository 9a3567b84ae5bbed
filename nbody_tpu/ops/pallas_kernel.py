"""Tiled all-pairs force kernel for the GPU, through Pallas on the Triton
route — the analog of the reference's whole single-device optimisation
ladder (ver3-ver8: SoA layout, SIMD reductions, cache tiling, threading).

The design is the standard tiled all-pairs GPU sweep (Nyland, Harris &
Prins, GPU Gems 3 ch. 31):

* particles live in a (4, N) float32 SoA table, rows [x, y, z, G*m]
  (16 B per particle; ``pack_particles``);
* the grid has one program per block of ``tile_i`` targets, whose
  coordinates stay in registers;
* inside the program a ``fori_loop`` streams the sources in tiles of
  ``tile_j`` (Triton pipelines those loads over ``num_stages``), forms
  the (tile_i, tile_j) pair matrix and adds it into element-wise float32
  accumulators held in registers, which are reduced over sources once,
  after the loop;
* the tails are zero-mass padding up to a whole block: a zero-mass
  source adds exactly zero, and padded targets are sliced off, so any N
  runs.

Self-interaction is included: dx=dy=dz=0 makes the term exactly zero
(matches ver0/GSimulation.cpp:132-147; do not mask the diagonal).

``dist_dtype='bfloat16'`` subtracts in float32, rounds the delta to bf16
and computes the rest in float32 (BASELINE.md config 3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..types import G_NEWTON, SOFTENING_SQUARED

# Measured best of the (tile_i, tile_j, num_warps) sweep on an H100 at
# N=16384 and N=262144 (PERF.md).
DEFAULT_TILE_I = 32
DEFAULT_TILE_J = 32


def _nbody_kernel(tgt_ref, src_ref, out_ref, *, tile_j, dist_dtype):
    f32 = jnp.float32
    xi = tgt_ref[0, :][:, None]  # (TI, 1)
    yi = tgt_ref[1, :][:, None]
    zi = tgt_ref[2, :][:, None]

    def body(j, acc):
        ax, ay, az = acc
        cols = pl.ds(pl.multiple_of(j * tile_j, tile_j), tile_j)
        xj = src_ref[0, cols][None, :]  # (1, TJ)
        yj = src_ref[1, cols][None, :]
        zj = src_ref[2, cols][None, :]
        gm = src_ref[3, cols][None, :]
        dx = xj - xi  # (TI, TJ)
        dy = yj - yi
        dz = zj - zi
        if dist_dtype == jnp.bfloat16:
            # Subtract in f32 and only then narrow: casting positions
            # first would catastrophically cancel for near pairs.
            dx = dx.astype(jnp.bfloat16).astype(f32)
            dy = dy.astype(jnp.bfloat16).astype(f32)
            dz = dz.astype(jnp.bfloat16).astype(f32)
        d2 = dx * dx + dy * dy + dz * dz + f32(SOFTENING_SQUARED)
        inv = jax.lax.rsqrt(d2)
        w = gm * (inv * inv * inv)
        return ax + w * dx, ay + w * dy, az + w * dz

    # Element-wise (TI, TJ) accumulators, reduced over sources once after
    # the loop: a cross-thread reduction inside the loop measured ~4x
    # slower on an H100 (PERF.md).
    zero = jnp.zeros((tgt_ref.shape[1], tile_j), f32)
    n_tiles = src_ref.shape[1] // tile_j
    ax, ay, az = jax.lax.fori_loop(0, n_tiles, body, (zero, zero, zero))
    out_ref[0, :] = jnp.sum(ax, axis=1)
    out_ref[1, :] = jnp.sum(ay, axis=1)
    out_ref[2, :] = jnp.sum(az, axis=1)
    out_ref[3, :] = jnp.zeros((tgt_ref.shape[1],), f32)


def pack_particles(pos: jax.Array, mass: jax.Array, multiple: int) -> jax.Array:
    """(3,N) positions + (N,) masses -> the kernel's (4, N') table, rows
    [x, y, z, G*m], zero-padded to N' = the next multiple of ``multiple``
    (padding has zero mass, so it is force-neutral as a source)."""
    n = pos.shape[1]
    gm = (mass * jnp.float32(G_NEWTON)).astype(jnp.float32)
    table = jnp.concatenate([pos.astype(jnp.float32), gm[None, :]], axis=0)
    return jnp.pad(table, ((0, 0), (0, -n % multiple)))


def _num_warps(tile_i: int, tile_j: int) -> int:
    # 8-16 pair elements per thread, at most 4 warps: each element holds
    # three accumulators in registers, and more warps measured slower.
    return max(1, min(4, tile_i * tile_j // 256))


def accelerations_between(
    pos_tgt: jax.Array,
    pos_src: jax.Array,
    mass_src: jax.Array,
    tile_i: int = DEFAULT_TILE_I,
    tile_j: int = DEFAULT_TILE_J,
    dist_dtype: str = "float32",
    interpret: bool = False,
) -> jax.Array:
    """Accelerations of targets due to sources via the tiled kernel.

    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> (3, Nt) fp32.
    Any Nt, Ns: both are zero-padded to whole tiles inside.  Tiles are
    powers of two (Triton's block shapes); ``interpret=True`` runs the
    kernel in the Pallas interpreter (the CPU test path)."""
    for name, t in (("tile_i", tile_i), ("tile_j", tile_j)):
        if t < 1 or t & (t - 1):
            raise ValueError(f"{name}={t} must be a power of two")
    nt = pos_tgt.shape[1]
    tgt = pack_particles(pos_tgt, jnp.zeros((nt,), jnp.float32), tile_i)
    src = pack_particles(pos_src, mass_src, tile_j)
    nt_pad, ns_pad = tgt.shape[1], src.shape[1]
    ddt = jnp.dtype(dist_dtype)
    out = pl.pallas_call(
        functools.partial(_nbody_kernel, tile_j=tile_j, dist_dtype=ddt),
        grid=(nt_pad // tile_i,),
        in_specs=[
            pl.BlockSpec((4, tile_i), lambda i: (0, i)),
            pl.BlockSpec((4, ns_pad), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((4, tile_i), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((4, nt_pad), jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(tile_i, tile_j), num_stages=2),
        cost_estimate=pl.CostEstimate(
            flops=20 * nt_pad * ns_pad,
            bytes_accessed=16 * (nt_pad // tile_i) * ns_pad + 32 * nt_pad,
            transcendentals=nt_pad * ns_pad,
        ),
        backend="triton",
        interpret=interpret,
        name="nbody_pairs",
    )(tgt, src)
    return out[0:3, :nt]


def accelerations(pos: jax.Array, mass: jax.Array, **opts) -> jax.Array:
    """All-pairs self-accelerations. pos (3,N), mass (N,) -> (3,N)."""
    return accelerations_between(pos, pos, mass, **opts)
