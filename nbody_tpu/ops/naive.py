"""Naive all-pairs force kernel in pure jnp — the on-device correctness oracle.

This is the analog of the reference's scalar ladder rungs ver0-ver2
(ver0/GSimulation.cpp:130-150 with ver2's float-consistent constants,
ver2/GSimulation.cpp:114-143): one O(N^2) softened-gravity evaluation,
expressed as broadcasted jnp ops and left to XLA to fuse and tile.

Kernels are plain traceable functions (jit is applied at the sample-block
level by the engine).  The general form computes accelerations of a target
set due to a source set — the primitive the sharded data-decomposition
layer composes (each shard: local targets x streamed sources), mirroring
the reference's MPI i-slice partitioning (ver5_all/programming_models/
cpu/Compute.cpp:47-58).

To bound memory at large N the target axis is processed in chunks via
``lax.map``.  The chunk is sized from N so that one chunk's temporaries
(the (3, C, N) deltas and the (C, N) weights, ``TEMP_BYTES_PER_PAIR`` per
pair) stay under ``CHUNK_BUDGET_BYTES``.

The source sum is pinned to full float32 (``Precision.HIGHEST``): on a GPU
an unpinned float32 contraction may run in TF32, which keeps about three
decimal digits and would break the golden kinetic-energy traces.

Self-interaction is included (dx=0 makes it exactly zero), matching the
reference (ver0/GSimulation.cpp:132-147).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import G_NEWTON, SOFTENING_SQUARED


# (3, C, N) deltas + (C, N) d2/inv/weights, all float32.
TEMP_BYTES_PER_PAIR = 24
CHUNK_BUDGET_BYTES = 2 << 30


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def chunk_for(nt: int, ns: int) -> int:
    """Target chunk for an (nt targets x ns sources) sweep: the largest
    divisor of nt whose temporaries fit CHUNK_BUDGET_BYTES."""
    cap = max(1, CHUNK_BUDGET_BYTES // (TEMP_BYTES_PER_PAIR * max(ns, 1)))
    return _largest_divisor_leq(nt, cap)


def _acc_block(pos_t: jax.Array, pos_s: jax.Array, gm: jax.Array,
               dist_dtype) -> jax.Array:
    """Accelerations on a block of targets. pos_t (3,C), pos_s (3,N), gm (N,)."""
    # Deltas are computed in f32 and only then narrowed: casting positions
    # before subtracting would catastrophically cancel for near pairs.
    d = pos_s[:, None, :] - pos_t[:, :, None]
    d = d.astype(dist_dtype).astype(jnp.float32)  # accumulate in f32
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + jnp.float32(SOFTENING_SQUARED)
    inv = jax.lax.rsqrt(d2)
    w = gm[None, :] * (inv * inv * inv)  # (C, N)
    # sum over sources: (3, C)
    return jnp.einsum("acn,cn->ac", d, w, precision=jax.lax.Precision.HIGHEST)


def accelerations_between(
    pos_tgt: jax.Array,
    pos_src: jax.Array,
    mass_src: jax.Array,
    chunk: int = 0,
    dist_dtype: str = "float32",
) -> jax.Array:
    """Accelerations of targets due to sources.

    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> acc (3, Nt), fp32.
    ``dist_dtype='bfloat16'`` computes pairwise deltas in bf16 with fp32
    accumulation (BASELINE.md config 3); default is full fp32.
    ``chunk`` caps the target chunk (0 = sized by bytes, ``chunk_for``).
    """
    nt = pos_tgt.shape[1]
    gm = (mass_src * jnp.float32(G_NEWTON)).astype(jnp.float32)
    ddt = jnp.dtype(dist_dtype)
    c = _largest_divisor_leq(nt, chunk) if chunk else chunk_for(
        nt, pos_src.shape[1])
    blocks = pos_tgt.reshape(3, nt // c, c).transpose(1, 0, 2)  # (nb, 3, c)
    acc = jax.lax.map(lambda pt: _acc_block(pt, pos_src, gm, ddt), blocks)
    return acc.transpose(1, 0, 2).reshape(3, nt)


def accelerations(pos: jax.Array, mass: jax.Array, **opts) -> jax.Array:
    """All-pairs self-accelerations. pos (3,N), mass (N,) -> (3,N).

    Pallas-specific registry options (tiles, interpret) are accepted and
    ignored so ``naive`` is drop-in wherever a kernel name is configurable.
    """
    for k in ("tile_i", "tile_j", "interpret"):
        opts.pop(k, None)
    return accelerations_between(pos, pos, mass, **opts)
