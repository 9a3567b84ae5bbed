"""The reference FLOP-count model (ver0/GSimulation.cpp:122):
flops/step = (11 + 18) * N^2 + 19 * N.

All GFlop/s numbers this framework reports use this model so they are
directly comparable with the reference's printed numbers, regardless of
how many flops the device kernels actually execute."""

from __future__ import annotations


def step_flops(n: int) -> float:
    nd = float(n)
    return (11.0 + 18.0) * nd * nd + nd * 19.0


def step_gflops(n: int) -> float:
    return 1e-9 * step_flops(n)


def pairs_per_step(n: int) -> float:
    return float(n) * float(n)
