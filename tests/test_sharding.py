"""Multi-device data decomposition on an 8-virtual-device CPU mesh.

Validates the GSPMD particle sharding + collectives against the
single-device path — the testing the reference's MPI layer never had
(SURVEY.md §4; latent MPI bugs documented in §2.4)."""

import numpy as np
import pytest

import jax

from nbody_tpu.init import make_state
from nbody_tpu.models.gravity import make_accel_fn, make_block_fn
from nbody_tpu.parallel.decompose import (
    make_sharded_block_fn,
    shard_state,
    state_specs,
)
from nbody_tpu.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _single_device_reference(n, steps):
    state = make_state(n, pad_multiple=8)
    blk = make_block_fn(make_accel_fn("naive"), 0.1, steps)
    return blk(state)


@pytest.mark.parametrize("comm", ["allgather", "ring"])
def test_sharded_matches_single_device(comm):
    n, steps = 512, 10
    ref_state, ref_ke = _single_device_reference(n, steps)

    state = make_state(n, pad_multiple=8)
    sharded, mesh = shard_state(state, 8)
    blk = make_sharded_block_fn("naive", {}, 0.1, steps, mesh, comm=comm)
    out_state, ke = blk(sharded)

    np.testing.assert_allclose(
        np.asarray(out_state.pos), np.asarray(ref_state.pos), rtol=2e-6, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(out_state.vel), np.asarray(ref_state.vel), rtol=2e-6, atol=1e-10
    )
    assert float(ke) == pytest.approx(float(ref_ke), rel=1e-5)


def test_ring_equals_allgather():
    n, steps = 256, 5
    state = make_state(n, pad_multiple=8)
    sharded, mesh = shard_state(state, 8)
    ag = make_sharded_block_fn("naive", {}, 0.1, steps, mesh, comm="allgather")
    rg = make_sharded_block_fn("naive", {}, 0.1, steps, mesh, comm="ring")
    st_a, ke_a = ag(sharded)
    st_r, ke_r = rg(sharded)
    np.testing.assert_allclose(
        np.asarray(st_a.pos), np.asarray(st_r.pos), rtol=1e-6, atol=1e-12
    )
    assert float(ke_a) == pytest.approx(float(ke_r), rel=1e-6)


def test_sharded_state_placement():
    state = make_state(512, pad_multiple=8)
    sharded, mesh = shard_state(state, 8)
    assert len(sharded.pos.sharding.device_set) == 8
    specs = state_specs()
    assert sharded.pos.sharding.spec == specs.pos


def test_sharded_pallas_interpret():
    # The production multi-chip path is shard_map over the Pallas kernel;
    # exercise that exact composition with the kernel in interpreter mode.
    n, steps = 512, 3
    state = make_state(n, pad_multiple=8)
    sharded, mesh = shard_state(state, 8)
    opts = dict(tile_i=32, tile_j=64, interpret=True)
    blk = make_sharded_block_fn("pallas", opts, 0.1, steps, mesh, comm="ring")
    out_state, ke = blk(sharded)

    ref_state, ref_ke = _single_device_reference(n, steps)
    np.testing.assert_allclose(
        np.asarray(out_state.pos), np.asarray(ref_state.pos), rtol=2e-5,
        atol=1e-9,
    )
    assert float(ke) == pytest.approx(float(ref_ke), rel=1e-4)


def test_sharded_bf16_matches_single_device():
    n, steps = 256, 5
    opts = dict(dist_dtype="bfloat16")
    state = make_state(n, pad_multiple=8)
    blk1 = make_block_fn(make_accel_fn("naive", **opts), 0.1, steps)
    ref_state, ref_ke = blk1(state)
    sharded, mesh = shard_state(state, 8)
    blk8 = make_sharded_block_fn("naive", opts, 0.1, steps, mesh, comm="ring")
    out_state, ke = blk8(sharded)
    np.testing.assert_allclose(
        np.asarray(out_state.pos), np.asarray(ref_state.pos), rtol=2e-6,
        atol=1e-10,
    )
    assert float(ke) == pytest.approx(float(ref_ke), rel=1e-5)


def test_sharded_leapfrog_matches_single_device():
    n, steps = 256, 8
    state = make_state(n, pad_multiple=8)
    blk1 = make_block_fn(make_accel_fn("naive"), 0.1, steps,
                         integrator="leapfrog")
    ref_state, ref_ke = blk1(state)

    sharded, mesh = shard_state(state, 8)
    blk8 = make_sharded_block_fn("naive", {}, 0.1, steps, mesh,
                                 comm="ring", integrator="leapfrog")
    out_state, ke = blk8(sharded)
    np.testing.assert_allclose(
        np.asarray(out_state.pos), np.asarray(ref_state.pos), rtol=2e-6,
        atol=1e-10,
    )
    assert float(ke) == pytest.approx(float(ref_ke), rel=1e-5)


def test_mesh_construction():
    mesh = make_mesh(4)
    assert mesh.devices.shape == (4,)
    with pytest.raises(ValueError):
        make_mesh(1000)


def test_uneven_shard_rejected():
    state = make_state(100)  # 100 not divisible by 8
    with pytest.raises(ValueError):
        shard_state(state, 8)


@pytest.mark.parametrize("k", [8, 3, 2])
def test_pallas_ring_matches_single_device(k):
    """The tiled kernel's between form through the ppermute ring agrees
    with the single-device reference for odd and even shard counts
    (shards hold N/K particles, not a tile multiple)."""
    n = 500
    state = make_state(n, pad_multiple=48)  # 528: divisible by 2,3,8
    ref_state, ref_ke = _single_device_reference_state(state, 5)
    mesh = make_mesh(k)
    sharded, _ = shard_state(state, k, mesh=mesh)
    opts = dict(tile_i=32, tile_j=64, interpret=True)
    blk = make_sharded_block_fn("pallas", opts, 0.1, 5, mesh, comm="ring")
    out, ke = blk(sharded)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref_state.pos),
        rtol=2e-6, atol=1e-10, err_msg=f"K={k}",
    )
    assert float(ke) == pytest.approx(float(ref_ke), rel=1e-5)


def _single_device_reference_state(state, steps):
    from nbody_tpu.models.gravity import make_accel_fn
    from nbody_tpu.models.integrators import make_block_fn

    return make_block_fn(make_accel_fn("naive"), 0.1, steps)(state)


def test_pallas_allgather_leapfrog():
    state = make_state(512, pad_multiple=8)
    from nbody_tpu.models.gravity import make_accel_fn
    from nbody_tpu.models.integrators import make_block_fn

    _, ref_ke = make_block_fn(
        make_accel_fn("naive"), 0.1, 5, integrator="leapfrog"
    )(state)
    mesh = make_mesh(8)
    sharded, _ = shard_state(state, 8, mesh=mesh)
    blk = make_sharded_block_fn(
        "pallas", dict(tile_i=32, tile_j=32, interpret=True), 0.1, 5, mesh,
        comm="allgather", integrator="leapfrog",
    )
    _, ke = blk(sharded)
    assert float(ke) == pytest.approx(float(ref_ke), rel=1e-5)


@pytest.mark.parametrize("kern,opts", [
    ("pm", dict(grid=16)),
    ("p3m", dict(grid=32, capacity=64)),
])
def test_sharded_mesh_solver_matches_single_device(kern, opts):
    """The distributed mesh solve (local deposit + grid psum,
    pm.sharded_accelerations — round-2 VERDICT item 2) must agree with
    the single-device solver; a clustered IC exercises the psum'd box
    statistics, octant monopoles and (p3m) the gathered short-range
    table."""
    n, steps = 512, 3
    state = make_state(n, pad_multiple=8, distribution="plummer")
    ref_state, ref_ke = make_block_fn(
        make_accel_fn(kern, **opts), 0.01, steps
    )(state)
    sharded, mesh = shard_state(state, 8)
    blk = make_sharded_block_fn(kern, opts, 0.01, steps, mesh,
                                comm="allgather")
    out, ke = blk(sharded)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref_state.pos), rtol=2e-5,
        atol=1e-8,
    )
    assert float(ke) == pytest.approx(float(ref_ke), rel=1e-5)


def test_sharded_p3m_forwards_measured_sr_plan(monkeypatch):
    """The sharded builder must pass the engine's measured SR plan
    (sr_slabs/sr_entries) through to pm.sharded_accelerations — dropping
    it falls back to the 2^22-capped default and silently loses
    worklist entries on clustered N >~ 1M."""
    from nbody_tpu.ops import pm as pm_ops

    captured = {}
    orig = pm_ops.sharded_accelerations

    def spy(p, m, axis, **kw):
        captured.update(kw)
        return orig(p, m, axis, **kw)

    monkeypatch.setattr(pm_ops, "sharded_accelerations", spy)
    state = make_state(256, pad_multiple=8)
    sharded, mesh = shard_state(state, 4)
    blk = make_sharded_block_fn(
        "p3m", dict(grid=32, capacity=64, sr_slabs=128, sr_entries=2048),
        0.01, 1, mesh, comm="allgather")
    blk(sharded)
    assert captured.get("sr_slabs") == 128
    assert captured.get("sr_entries") == 2048


def test_sharded_mesh_rejects_ring():
    state = make_state(256, pad_multiple=8)
    sharded, mesh = shard_state(state, 8)
    with pytest.raises(ValueError, match="allgather"):
        make_sharded_block_fn("p3m", {}, 0.1, 2, mesh, comm="ring")


def test_sharded_pm_cost_model_scales():
    """Compiler-side proof that the local-deposit + grid-psum mesh
    decomposition splits the per-shard deposit/gather work, immune to
    the virtual mesh's shared-core wall clock (all 8 "devices" run on
    the same host, so timing understates the win — DESIGN.md
    "Distributed mesh solve").  The FFT convolution is replicated BY
    DESIGN (O(ng^3 log ng), cheap), so per-shard flops and
    transcendentals barely move; the deposit tier that must scale as
    N/K shows up in XLA's bytes-accessed count.  Measured at
    N=65536/ng=32/K=8: 9.07e7 vs 1.59e8 bytes (1.75x lower), equal
    transcendentals (the shared replicated FFT)."""
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from nbody_tpu.ops import pm
    from nbody_tpu.parallel.mesh import AXIS

    n, ng, k = 65536, 32, 8
    state = make_state(n, pad_multiple=1024 * k)
    sharded, mesh = shard_state(state, k)

    def psum_mesh(pos_l, mass_l):
        return pm.sharded_accelerations(pos_l, mass_l, AXIS, grid=ng)

    def replicated(pos_l, mass_l):
        pos = lax.all_gather(pos_l, AXIS, axis=1, tiled=True)
        m = lax.all_gather(mass_l, AXIS, axis=0, tiled=True)
        return pm.accelerations_between(pos_l, pos, m, grid=ng)

    def cost(fn):
        smf = jax.shard_map(fn, mesh=mesh, in_specs=(P(None, AXIS), P(AXIS)),
                        out_specs=P(None, AXIS), check_vma=False)
        ca = (jax.jit(smf).lower(sharded.pos, sharded.mass)
              .compile().cost_analysis())
        return ca[0] if isinstance(ca, (list, tuple)) else ca

    new, old = cost(psum_mesh), cost(replicated)
    assert new["bytes accessed"] < 0.7 * old["bytes accessed"], (
        new["bytes accessed"], old["bytes accessed"])
    # ...while the replicated-FFT work stays put (the split moved the
    # deposit, not the convolution)
    assert (new.get("transcendentals", 0.0)
            <= 1.05 * old.get("transcendentals", 1.0)), (
        new.get("transcendentals"), old.get("transcendentals"))

def _opt_hlo(fn, in_specs, out_specs, mesh, *args):

    smf = jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                    out_specs=out_specs, check_vma=False)
    return jax.jit(smf).lower(*args).compile().as_text()


def test_ring_permute_chain_is_compute_independent():
    """Structural overlap guarantee for the ring (round-3 VERDICT item
    6): in the OPTIMIZED HLO, every hop's collective-permute consumes
    the PREVIOUS permute's output directly — never anything derived from
    the pair kernel — so the whole K-1-hop permute chain is dataflow-
    independent of the force computation and XLA's scheduler is FREE to
    run hop n+1's transfer under hop n's compute.  (Timing needs
    several cards — ROADMAP; this pins the property the overlap claim
    rests on.)  A regression that threads the ring buffer
    through the force math (serializing the ring) breaks the chain and
    fails here."""
    import re

    from jax.sharding import PartitionSpec as P

    from nbody_tpu.ops import registry
    from nbody_tpu.parallel.decompose import _accel_ring
    from nbody_tpu.parallel.mesh import AXIS

    k = 8
    state = make_state(512, pad_multiple=8)
    sharded, mesh = shard_state(state, k)
    between = registry.get_between("naive")

    def fn(pos_l, mass_l):
        return _accel_ring(between, pos_l, mass_l)

    txt = _opt_hlo(fn, (P(None, AXIS), P(AXIS)), P(None, AXIS), mesh,
                   sharded.pos, sharded.mass)
    # The ring must BE a ring: K-1 hops, no all-gather materialization.
    defs = re.findall(
        r"%(\S+) = \S+ collective-permute(?:-start)?\(%(\S+)\)", txt)
    assert len(defs) == k - 1, txt.count("collective-permute")
    assert "all-gather" not in txt
    names = {name for name, _ in defs}
    operands = [op for _, op in defs]
    # Chain property: every permute after the first consumes a permute.
    chained = sum(op in names for op in operands)
    assert chained == k - 2, (operands, names)
    # The chain head consumes the packed loop-carried buffer, not the
    # force math: its producer line must be free of kernel arithmetic.
    head_op = next(op for op in operands if op not in names)
    head_def = next(line for line in txt.splitlines()
                    if line.strip().startswith(f"%{head_op} ="))
    assert not re.search(r"rsqrt|sqrt|divide|dot\(", head_def), head_def


def test_psum_mesh_reduces_grid_once():
    """The distributed mesh solve's collective budget (round-3 VERDICT
    item 6): ONE all-reduce carries the (ng,ng,ng) mass grid (XLA may
    combine it with the small box/octant psums into a tuple all-reduce —
    still one collective), and the only all-gather is the O(1) robust-
    box quantile subsample.  A regression to the replicated round-2
    scheme (all-gather positions, K x deposit) adds position-sized
    gathers and fails here."""
    import re

    from jax.sharding import PartitionSpec as P

    from nbody_tpu.ops import pm
    from nbody_tpu.parallel.mesh import AXIS

    ng = 32
    state = make_state(16384, pad_multiple=2048)
    sharded, mesh = shard_state(state, 8)

    def fn(pos_l, mass_l):
        return pm.sharded_accelerations(pos_l, mass_l, AXIS, grid=ng)

    txt = _opt_hlo(fn, (P(None, AXIS), P(AXIS)), P(None, AXIS), mesh,
                   sharded.pos, sharded.mass)
    grid_shape = f"f32[{ng},{ng},{ng}]"
    # `.*`, not `[^=]*`: a combined tuple all-reduce's shape list holds
    # /*index=N*/ comments whose '=' would break the match.
    ar_defs = [line for line in txt.splitlines()
               if re.search(r"= .*\ball-reduce(?:-start)?\(", line)]
    grid_reduces = [line for line in ar_defs if grid_shape in line]
    assert len(grid_reduces) == 1, ar_defs
    # No collective moves particle-sized data: the one all-gather is the
    # bounded box-statistics subsample (<= 3 x 64k floats).
    assert txt.count("all-gather") <= 1
