"""Bit-exact host oracle reproducing the reference ver0 arithmetic.

This module exists for one purpose: to reproduce the compiled C++ reference's
trajectory (and hence its kinetic-energy trace) *exactly*, operation for
operation, so the device kernels have a trustworthy fidelity anchor.  The
system is chaotic — by step 500 any reordering of fp32 sums diverges
macroscopically — so "to 1e-4 relative" at step 500 effectively means
bit-exact replication of ver0's mixed fp32/fp64 arithmetic
(ver0/GSimulation.cpp:127-173):

* dx,dy,dz and their squares/sums: fp32 (:138-142)
* distanceSqr adds the *double* literal 1e-3, result truncated to fp32 (:114,:142)
* distanceInv = fp32( 1.0 / sqrt(double(distanceSqr)) ) (:143)
* the per-pair force term is evaluated left-associatively in fp64:
  ((((dx*G)*m_j)*inv)*inv)*inv (:145-147, G is a double literal :116)
* acc accumulates sequentially over j as fp32( fp64(acc) + term ) (:145-147)
* integration (vel += acc*dt; pos += vel*dt) elementwise fp32 (:155-161)
* kinetic energy: sequential fp32 sum of m*|v|^2 terms, halved (:167-173)

Everything here is plain numpy: each ufunc is separately IEEE-rounded with
no FMA contraction, matching the SSE2 code g++ emits for the reference.
Self-interaction (j == i) is NOT skipped — softening absorbs it and the
term is exactly zero because dx=dy=dz=0 (:132-147).

This oracle is O(N^2) fp64 on host and intentionally slow; use it for
tests and golden-trace generation, not production runs.
"""

from __future__ import annotations

import numpy as np

from .types import G_NEWTON, SOFTENING_SQUARED

_F32 = np.float32
_F64 = np.float64


def accelerations_ref64(
    pos: np.ndarray, mass: np.ndarray
) -> np.ndarray:
    """Exact ver0 per-step accelerations. pos (3,N) f32, mass (N,) f32 -> (3,N) f32."""
    n = pos.shape[1]
    # dx[i, j] = pos[j] - pos[i]  (fp32, ver0/GSimulation.cpp:138-140)
    terms = []
    d32 = [None] * 3
    for a in range(3):
        d32[a] = pos[a][None, :] - pos[a][:, None]  # (N_i, N_j) fp32
    # distanceSqr: fp32 partial sums, then + double(1e-3), truncate to fp32 (:142)
    s = (d32[0] * d32[0] + d32[1] * d32[1]) + d32[2] * d32[2]  # fp32
    d2 = (s.astype(_F64) + SOFTENING_SQUARED).astype(_F32)
    # distanceInv = fp32(1.0 / sqrt(double)) (:143)
    inv = (1.0 / np.sqrt(d2.astype(_F64))).astype(_F32)
    inv64 = inv.astype(_F64)
    m64 = mass.astype(_F64)
    for a in range(3):
        # left-associative fp64 chain (:145-147)
        t = d32[a].astype(_F64) * G_NEWTON
        t *= m64[None, :]
        t *= inv64
        t *= inv64
        t *= inv64
        terms.append(t)  # (N_i, N_j) fp64
    # Sequential fp32 fold over j: acc = fp32(fp64(acc) + term_j)
    acc = np.zeros((3, n), dtype=_F32)
    t0, t1, t2 = terms
    for j in range(n):
        acc[0] = (acc[0].astype(_F64) + t0[:, j]).astype(_F32)
        acc[1] = (acc[1].astype(_F64) + t1[:, j]).astype(_F32)
        acc[2] = (acc[2].astype(_F64) + t2[:, j]).astype(_F32)
    return acc


def step_ref64(
    pos: np.ndarray, vel: np.ndarray, mass: np.ndarray, dt: float
) -> tuple[np.ndarray, np.ndarray, np.float32]:
    """One exact ver0 step. Returns (pos, vel, kenergy), all new arrays."""
    dt = _F32(dt)
    acc = accelerations_ref64(pos, mass)
    vel = vel + acc * dt  # fp32 elementwise (:155-157)
    pos = pos + vel * dt  # fp32 elementwise (:159-161)
    # energy += m * |v|^2, sequential fp32 (:167-171).  np.cumsum accumulates
    # sequentially in-dtype, reproducing the C++ fold exactly.
    ke_terms = mass * ((vel[0] * vel[0]) + (vel[1] * vel[1]) + (vel[2] * vel[2]))
    energy = np.cumsum(ke_terms.astype(_F32))[-1] if len(ke_terms) else _F32(0)
    return pos, vel, _F32(0.5) * _F32(energy)


def run_ref64(
    n: int,
    nsteps: int,
    dt: float = 0.1,
    sfreq: int = 50,
    engine: str = "auto",
) -> list[tuple[int, np.float32]]:
    """Run the oracle from reference initial conditions; return the
    (step, kenergy) samples the reference would print.

    engine: 'numpy' (this module), 'native' (the C++ engine in
    native/oracle_engine.cpp, bit-identical and ~50x faster), or 'auto'
    (native when buildable, else numpy)."""
    from .init import reference_init_arrays
    from .utils import native

    pos, vel, mass = reference_init_arrays(n)
    if engine == "auto":
        engine = "native" if native.available() else "numpy"
    if engine == "native":
        trace = native.oracle_run(pos, vel, mass, nsteps, dt)
        return [(s, trace[s - 1]) for s in range(sfreq, nsteps + 1, sfreq)]
    samples = []
    for s in range(1, nsteps + 1):
        pos, vel, ke = step_ref64(pos, vel, mass, dt)
        if s % sfreq == 0:
            samples.append((s, ke))
    return samples
