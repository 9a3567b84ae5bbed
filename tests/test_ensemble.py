"""Ensemble tier: vmap'd sample blocks over independent members
(models/ensemble.py — a functional-transform capability the reference's
per-process GSimulation architecture has no analog for)."""

import jax
import numpy as np
import pytest

from nbody_tpu.init import make_state
from nbody_tpu.models.ensemble import (
    make_ensemble_block_fn,
    member,
    stack_states,
)
from nbody_tpu.models.gravity import make_accel_fn, make_block_fn


def _members(e, n, pad=8):
    return [make_state(n, pad_multiple=pad, seed=100 + i)
            for i in range(e)]


@pytest.mark.parametrize("kernel,opts", [
    ("naive", {}),
    ("pallas", dict(interpret=True, tile_i=64, tile_j=64)),
    ("pm", dict(grid=16)),
    ("pm", dict(grid=16, cutoff_cells=4, capacity=64)),
])
def test_ensemble_matches_per_member(kernel, opts):
    """One vmap'd block == E independent blocks, every kernel family
    (incl. the Pallas sweep's batch grid dim and the mesh tiers'
    batched FFTs)."""
    e, n, steps = 3, 192, 4
    states = _members(e, n)
    accel = make_accel_fn(kernel, **opts)
    ens_out, kes = make_ensemble_block_fn(accel, 0.05, steps)(
        stack_states(states))
    blk = make_block_fn(accel, 0.05, steps)
    for i, s in enumerate(states):
        ref, ke_ref = blk(s)
        got = member(ens_out, i)
        np.testing.assert_allclose(np.asarray(got.pos),
                                   np.asarray(ref.pos), rtol=2e-6,
                                   atol=1e-7)
        assert abs(float(kes[i]) - float(ke_ref)) <= 1e-6 * max(
            1.0, abs(float(ke_ref)))


@pytest.mark.parametrize("kernel,opts", [
    ("naive", {}),
    ("pallas", dict(interpret=True, tile_i=64, tile_j=64)),
    ("pm", dict(grid=16)),
])
def test_ensemble_sharded_over_members(kernel, opts):
    """The ensemble axis shards over the device mesh with NO
    collectives for EVERY kernel family and stays exact.  shard_map
    places whole members per device — GSPMD auto-partitioning cannot
    split a vmapped FFT or Pallas kernel without inserting all-gathers
    (the original with_sharding_constraint formulation did exactly
    that; caught by this test's HLO scan once parametrized)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from nbody_tpu.parallel.mesh import make_mesh

    e, n, steps = 8, 128, 3
    states = _members(e, n)
    ens = stack_states(states)
    accel = make_accel_fn(kernel, **opts)
    mesh = make_mesh(8)
    fn = make_ensemble_block_fn(accel, 0.1, steps, mesh=mesh)
    out_sh, ke_sh = fn(ens)
    out, ke = make_ensemble_block_fn(accel, 0.1, steps)(ens)
    np.testing.assert_allclose(np.asarray(ke_sh), np.asarray(ke),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out_sh.pos),
                               np.asarray(out.pos), rtol=1e-6,
                               atol=1e-7)
    # no cross-member communication in the compiled program (reuses
    # fn's jit cache — no second trace)
    hlo = fn.lower(ens).compile().as_text()
    for coll in ("all-reduce", "all-gather", "collective-permute",
                 "all-to-all"):
        assert coll not in hlo, f"unexpected collective: {coll}"
    with pytest.raises(ValueError, match="divide"):
        fn(stack_states(_members(6, n)))


def test_stack_states_validation():
    a = make_state(64, pad_multiple=8, seed=1)
    b = make_state(96, pad_multiple=8, seed=2)
    with pytest.raises(ValueError, match="share"):
        stack_states([a, b])
    with pytest.raises(ValueError, match="at least one"):
        stack_states([])
    # member() must not silently clamp a wrong index (jnp indexing
    # would return the LAST member)
    ens = stack_states([a, make_state(64, pad_multiple=8, seed=3)])
    with pytest.raises(IndexError, match="out of range"):
        member(ens, 2)
    assert member(ens, -1).pos is not None


def test_ensemble_grad_flows():
    """The ensemble block differentiates member-wise (vmap composes
    with grad — sweep over ICs with one backward pass)."""
    e, n = 2, 96
    states = _members(e, n)
    ens = stack_states(states)
    blk = make_ensemble_block_fn(make_accel_fn("naive"), 0.05, 2)

    def loss(pos0):
        out, _ = blk(
            type(ens)(pos=pos0, vel=ens.vel, mass=ens.mass, n=ens.n))
        return (out.pos ** 2).sum()

    g = jax.grad(loss)(ens.pos)
    assert np.isfinite(np.asarray(g)).all()
    assert float(np.abs(np.asarray(g)).max()) > 0
