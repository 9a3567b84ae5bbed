"""End-to-end device stepping: the jitted fp32 sample-block loop must
reproduce the compiled C++ reference's kinetic-energy trace at full printed
precision for the golden configs."""

import os

import numpy as np
import pytest

from nbody_tpu.config import SimConfig
from nbody_tpu.init import make_state
from nbody_tpu.models.gravity import (
    euler_step,
    kinetic_energy,
    make_accel_fn,
    make_block_fn,
)
from nbody_tpu.simulation import run
from nbody_tpu.utils.reporting import _g5

from .util import parse_golden_trace


@pytest.mark.parametrize("n,steps,fname", [
    (128, 50, "ver0_n128_s50.txt"),
    (256, 100, "ver0_n256_s100.txt"),
    (1024, 200, "ver0_n1024_s200.txt"),
    (2000, 50, "ver0_n2000_s50.txt"),
])
def test_device_trace_matches_reference(golden_dir, n, steps, fname):
    golden = parse_golden_trace(os.path.join(golden_dir, fname))
    cfg = SimConfig(n=n, nsteps=steps, kernel="naive")
    result = run(cfg, quiet=True)
    assert len(result.samples) == len(golden)
    for (s_g, ke_g), (s, ke) in zip(golden, result.kenergy_trace):
        assert s == s_g
        assert _g5(ke) == ke_g, f"step {s}: {_g5(ke)} != {ke_g}"


def test_device_trace_numeric_tolerance(golden_dir):
    # The BASELINE.md fidelity gate: 1e-4 relative on the kenergy trace.
    golden = parse_golden_trace(os.path.join(golden_dir, "ver0_n2000_s50.txt"))
    cfg = SimConfig(n=2000, nsteps=50, kernel="naive")
    result = run(cfg, quiet=True)
    for (s_g, ke_g), (_, ke) in zip(golden, result.kenergy_trace):
        assert abs(ke - float(ke_g)) <= 1e-4 * abs(float(ke_g))


def test_block_fn_equals_stepwise():
    cfg = SimConfig(n=128, kernel="naive")
    state = make_state(cfg.n)
    accel = make_accel_fn("naive")
    blk = make_block_fn(accel, 0.1, 5)
    s_block, ke_block = blk(state)

    s_loop = state
    for _ in range(5):
        s_loop = euler_step(s_loop, accel, 0.1)
    # fori_loop and eager stepping may fuse differently (ulp-level), so
    # compare with a tight tolerance rather than bitwise.
    np.testing.assert_allclose(
        np.asarray(s_block.pos), np.asarray(s_loop.pos), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(s_block.vel), np.asarray(s_loop.vel), rtol=1e-6, atol=1e-9
    )
    assert float(ke_block) == pytest.approx(float(kinetic_energy(s_loop)), rel=1e-6)


def test_padding_does_not_change_dynamics():
    cfg_a = SimConfig(n=100, nsteps=10, kernel="naive")
    res_a = run(cfg_a, quiet=True)
    state = make_state(100, pad_multiple=64)  # padded to 128
    blk = make_block_fn(make_accel_fn("naive"), 0.1, 10)
    state2, ke2 = blk(state)
    # compare against unpadded run of the same steps
    state_u = make_state(100)
    blk_u = make_block_fn(make_accel_fn("naive"), 0.1, 10)
    state3, ke3 = blk_u(state_u)
    np.testing.assert_allclose(
        np.asarray(state2.pos)[:, :100], np.asarray(state3.pos), rtol=1e-6
    )
    assert float(ke2) == pytest.approx(float(ke3), rel=1e-6)
    assert res_a is not None


def test_momentum_conserved_through_integration():
    # Net force is zero for antisymmetric pairwise forces, so total
    # momentum sum(m*v) is conserved up to fp32 accumulation drift.
    cfg = SimConfig(n=512, nsteps=100, kernel="naive")
    state = make_state(cfg.n)
    p0 = (np.asarray(state.mass)[None, :] * np.asarray(state.vel)).sum(axis=1)
    blk = make_block_fn(make_accel_fn("naive"), 0.1, 100)
    state2, _ = blk(state)
    p1 = (np.asarray(state2.mass)[None, :] * np.asarray(state2.vel)).sum(axis=1)
    scale = np.abs(np.asarray(state2.mass)[None, :] * np.asarray(state2.vel)).sum()
    assert np.all(np.abs(p1 - p0) < 1e-5 * scale)


@pytest.mark.parametrize("n,steps,fname", [
    (128, 50, "ver0_n128_s50.txt"),
    (256, 100, "ver0_n256_s100.txt"),
    (512, 100, "ver0_n512_s100.txt"),
])
def test_pallas_trace_matches_reference(golden_dir, n, steps, fname):
    """The tiled kernel is the GPU's production path (kernel auto), so it
    must hold the same golden-trace invariant as naive; here through the
    engine in interpret mode."""
    golden = parse_golden_trace(os.path.join(golden_dir, fname))
    cfg = SimConfig(n=n, nsteps=steps, kernel="pallas", interpret=True)
    result = run(cfg, quiet=True)
    assert len(result.samples) == len(golden)
    for (s_g, ke_g), (s, ke) in zip(golden, result.kenergy_trace):
        assert s == s_g
        assert _g5(ke) == ke_g, (s, ke, ke_g)
