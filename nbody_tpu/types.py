"""Dtype policy for the N-body framework.

The reference fixes ``real_type = float`` (fp32) globally (ver0/types.hpp:21).
We keep fp32 state and offer three force-kernel precision modes:

* ``f32``   — fp32 distances and accumulation (ver2+ "float consistency"
              semantics, ver2/GSimulation.cpp:114-143).  Default.
* ``bf16``  — bf16 pairwise deltas with fp32 accumulation (mixed
              precision; BASELINE.md config 3).
* ``ref64`` — the ver0 mixed fp32/fp64 semantics (double softening/G
              promotion, ver0/GSimulation.cpp:114-147), used by the
              bit-exact oracle for fidelity tests.
"""

from __future__ import annotations

import numpy as np

# Physics constants, as the reference defines them (ver0/GSimulation.cpp:114-116).
SOFTENING_SQUARED = 1e-3
G_NEWTON = 6.67259e-11

STATE_DTYPE = np.float32  # fp32 state everywhere (reference real_type)

# Engine precision modes (see module docstring).
PRECISIONS = ("f32", "bf16", "ref64")
