"""Particle state: an SoA pytree of device arrays.

The reference's ``ParticleSoA`` holds ten parallel heap arrays
(ver3/Particle.hpp:43-59).  Here the state is a single frozen
dataclass pytree of jnp arrays with coordinates stacked on a leading axis of
3 so each coordinate row is a contiguous vector:

* ``pos``  — (3, N) fp32
* ``vel``  — (3, N) fp32
* ``mass`` — (N,)  fp32

Acceleration is deliberately NOT part of the state: it is a pure
function of positions recomputed inside the fused step (the reference
instead persists and re-zeroes ``acc`` each step, ver0/GSimulation.cpp:163-165).

``n`` is the number of *real* particles; arrays may be padded beyond ``n``
to a lane/shard-divisible size with zero-mass particles, which contribute
exactly zero force and zero kinetic energy.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ParticleState:
    pos: jax.Array  # (3, N_padded) fp32
    vel: jax.Array  # (3, N_padded) fp32
    mass: jax.Array  # (N_padded,) fp32
    n: int = dataclasses.field(metadata=dict(static=True))  # real particles

    @property
    def n_padded(self) -> int:
        return self.pos.shape[1]


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def pad_state(
    pos: np.ndarray, vel: np.ndarray, mass: np.ndarray, n_padded: int
) -> ParticleState:
    """Pad host SoA arrays to ``n_padded`` with zero-mass particles.

    Padded particles are placed on a far-away diagonal line so they never
    coincide with real particles (their mass is zero, so they exert no
    force either way; spreading them out just keeps diagnostics clean).
    """
    n = pos.shape[1]
    assert n_padded >= n
    pad = n_padded - n
    if pad:
        far = 1.0e6 + np.arange(pad, dtype=np.float32)
        pos = np.concatenate([pos, np.tile(far, (3, 1))], axis=1)
        vel = np.concatenate([vel, np.zeros((3, pad), np.float32)], axis=1)
        mass = np.concatenate([mass, np.zeros(pad, np.float32)])
    return ParticleState(
        pos=jnp.asarray(pos, jnp.float32),
        vel=jnp.asarray(vel, jnp.float32),
        mass=jnp.asarray(mass, jnp.float32),
        n=n,
    )


def to_host(state: ParticleState) -> dict:
    """Fetch the real (unpadded) particles to host numpy arrays."""
    return dict(
        pos=np.asarray(state.pos)[:, : state.n],
        vel=np.asarray(state.vel)[:, : state.n],
        mass=np.asarray(state.mass)[: state.n],
        n=state.n,
    )


# AoS interop.  The reference's baseline layout is an array of structs with
# pos[3], vel[3], acc[3], mass per particle (ver0/Particle.hpp:26-41).  These
# converters exchange state with AoS tooling; acc round-trips as zeros since
# it is not state here (recomputed every step).

AOS_DTYPE = np.dtype(
    [("pos", np.float32, 3), ("vel", np.float32, 3),
     ("acc", np.float32, 3), ("mass", np.float32)]
)


def to_aos(state: ParticleState) -> np.ndarray:
    """Real particles as a structured AoS array (reference Particle layout)."""
    host = to_host(state)
    out = np.zeros(state.n, dtype=AOS_DTYPE)
    out["pos"] = host["pos"].T
    out["vel"] = host["vel"].T
    out["mass"] = host["mass"]
    return out


def from_aos(aos: np.ndarray, pad_multiple: int = 1) -> ParticleState:
    """Build a device state from a structured AoS array."""
    n = len(aos)
    return pad_state(
        np.ascontiguousarray(aos["pos"].T, np.float32),
        np.ascontiguousarray(aos["vel"].T, np.float32),
        np.ascontiguousarray(aos["mass"], np.float32),
        round_up(n, max(1, pad_multiple)),
    )
