"""P3M: the particle-mesh solver with the exact short-range correction
(ops/pm.py, cutoff_cells > 0; the round-2 VERDICT's top ask).

Contract: the force split f = f*S + f*(1-S) is an exact identity, so the
only error sources are the mesh discretization of the SMOOTH tapered
part (CIC-deconvolved) and cell-capacity overflow (which falls back to
mesh-quality full forces).  That makes P3M accurate precisely where
one-level PM was not — clustered distributions (reference force law:
ver0/GSimulation.cpp:130-150)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_tpu.models.distributions import cold_sphere, plummer
from nbody_tpu.ops import naive, pm


def _err(pos, mass, ng, cutoff, cap):
    return float(pm.force_error_vs_exact(pos, mass, ng, cutoff, cap))


def test_taper_properties():
    import jax.numpy as jnp

    q = jnp.linspace(-0.5, 1.5, 101)
    s = np.asarray(pm._taper(q))
    assert s[0] == 0.0 and s[-1] == 1.0
    assert np.all(np.diff(s) >= 0)  # monotone
    # compact support of the short-range factor: 1-S == 0 beyond R_c
    assert np.all(s[q >= 1.0] == 1.0)


def test_p3m_plummer_accuracy():
    """The VERDICT round-2 'done' criterion (scaled to CI size; the
    N=8192 measurement — 4.3e-3 / 3.1e-3 at ng=64/128 vs pm's 0.43/0.18
    — is recorded in docs/DESIGN.md)."""
    pos, _, mass = plummer(2048, seed=1)
    cap = pm.suggest_capacity(pos, mass, 64, 4)
    assert _err(pos, mass, 64, 4, cap) < 1.5e-2
    cap = pm.suggest_capacity(pos, mass, 128, 4)
    assert _err(pos, mass, 128, 4, cap) < 8e-3


def test_p3m_beats_pm_on_clustered():
    pos, _, mass = plummer(2048, seed=2)
    e_pm = _err(pos, mass, 64, 0, 0)
    e_p3m = _err(pos, mass, 64, 4, pm.suggest_capacity(pos, mass, 64, 4))
    assert e_p3m < e_pm / 5, (e_pm, e_p3m)


def test_p3m_cutoff_is_accuracy_knob():
    """Error ~ cutoff^-3: a larger split radius must help."""
    pos, _, mass = cold_sphere(2048, seed=1)
    e4 = _err(pos, mass, 64, 4, 128)
    e8 = _err(pos, mass, 64, 8, 512)
    assert e8 < e4 / 2, (e4, e8)


def test_p3m_sub_resolution_cells():
    """Coarse meshes use half-R_c cells with a +-2 reach (sub=2); the
    path must stay accurate."""
    nc, sub = pm._cell_grid_params(32, 4)
    assert sub == 2 and nc == 16
    nc, sub = pm._cell_grid_params(128, 4)
    assert sub == 1 and nc == 32
    pos, _, mass = cold_sphere(1024, seed=3)
    e_pm = _err(pos, mass, 32, 0, 0)
    e_p3m = _err(pos, mass, 32, 4, 256)
    assert e_p3m < e_pm, (e_pm, e_p3m)
    assert e_p3m < 5e-2


def test_p3m_momentum_conserved():
    """With no capacity overflow the short-range pair sum is exactly
    antisymmetric and the mesh part is deposit/gather-symmetric with an
    antisymmetric (deconvolved) kernel: total momentum flux ~ 0."""
    pos, _, mass = cold_sphere(1024, seed=4)
    cap = pm.suggest_capacity(pos, mass, 64, 4)
    assert float(pm.cell_overflow_fraction(pos, mass, 64, 4, cap)) == 0.0
    a = np.asarray(pm.accelerations(pos, mass, grid=64, cutoff_cells=4,
                                    capacity=cap))
    flux = np.abs((mass[None, :] * a).sum(axis=1))
    scale = np.abs(mass[None, :] * a).sum()
    assert np.all(flux < 2e-6 * scale), (flux, scale)


def test_p3m_overflow_falls_back_to_mesh_quality():
    """Starving the cell list (capacity 8) must degrade accuracy toward
    plain PM — never below it (the complement-kernel deposit gives
    overflowed sources a mesh-quality FULL force)."""
    pos, _, mass = plummer(2048, seed=5)
    ov = float(pm.cell_overflow_fraction(pos, mass, 64, 4, 8))
    assert ov > 0.1  # the core genuinely overflows at capacity 8
    e_pm = _err(pos, mass, 64, 0, 0)
    e_starved = _err(pos, mass, 64, 4, 8)
    e_full = _err(pos, mass, 64, 4, pm.suggest_capacity(pos, mass, 64, 4))
    assert e_full < e_starved <= e_pm * 1.25, (e_full, e_starved, e_pm)


def test_p3m_zero_mass_padding_neutral():
    from nbody_tpu.init import make_state

    state = make_state(1000, pad_multiple=256)  # padded to 1024
    acc = np.asarray(pm.accelerations(state.pos, state.mass, grid=32,
                                      cutoff_cells=4, capacity=64))
    ref = np.asarray(pm.accelerations(state.pos[:, :1000],
                                      state.mass[:1000], grid=32,
                                      cutoff_cells=4, capacity=64))
    np.testing.assert_allclose(acc[:, :1000], ref, rtol=2e-5, atol=1e-8)


def test_p3m_between_matches_self():
    pos, _, mass = cold_sphere(512, seed=6)
    a_self = np.asarray(pm.p3m_accelerations(pos, mass, grid=32,
                                             capacity=64))
    a_btwn = np.asarray(pm.p3m_accelerations_between(pos, pos, mass,
                                                     grid=32, capacity=64))
    np.testing.assert_array_equal(a_self, a_btwn)


def test_p3m_registry_and_config():
    from nbody_tpu.config import SimConfig
    from nbody_tpu.ops import registry

    assert "p3m" in registry.available()
    fn = registry.get("p3m")
    pos, _, mass = cold_sphere(256, seed=7)
    a = np.asarray(fn(pos, mass, grid=32, capacity=64))
    assert np.all(np.isfinite(a))

    cfg = SimConfig(kernel="p3m", pm_grid=32, pm_cutoff=6, pm_capacity=128)
    opts = cfg.kernel_opts()
    assert opts == {"grid": 32, "cutoff_cells": 6, "capacity": 128}


def test_p3m_sharded_matches_single():
    """Sharded p3m (local mesh deposit + grid psum; short-range entry
    chunks split across shards + slot-table psum) agrees with the
    single-device solve to summation-order tolerance."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    kw = dict(n=512, nsteps=50, kernel="p3m", pm_grid=32,
              distribution="plummer", dt=0.01)
    res = run(SimConfig(shards=4, comm="allgather", **kw), quiet=True)
    ref = run(SimConfig(**kw), quiet=True)
    for (s, ke), (s_r, ke_r) in zip(res.kenergy_trace, ref.kenergy_trace):
        assert abs(ke - ke_r) <= 1e-4 * max(abs(ke_r), 1e-9), (s, ke, ke_r)


def test_suggest_sr_plan_measured_and_sufficient():
    """The measured plan (slab count S, worklist entries E) must give
    the SAME forces as the guaranteed default bounds — the plan is a
    memory/size optimization, never an accuracy knob — and starving
    sr_entries must degrade gracefully (finite, worse-or-equal)."""
    pos, _, mass = plummer(2048, seed=8)
    plan = pm.suggest_sr_plan(pos, mass, 64, 4)
    assert set(plan) == {"capacity", "sr_slabs", "sr_entries"}
    a_plan = np.asarray(pm.accelerations(pos, mass, grid=64,
                                         cutoff_cells=4, **plan))
    a_def = np.asarray(pm.accelerations(pos, mass, grid=64,
                                        cutoff_cells=4,
                                        capacity=plan["capacity"]))
    np.testing.assert_allclose(a_plan, a_def, rtol=1e-5, atol=1e-10)
    # plan sizes are powers of two (stable jit shapes on re-suggestion)
    for key in ("sr_slabs", "sr_entries"):
        v = plan[key]
        assert v >= 64 and (v & (v - 1)) == 0, (key, v)
    # truncation: a starved worklist drops SR pairs but stays finite
    a_trunc = np.asarray(pm.accelerations(
        pos, mass, grid=64, cutoff_cells=4, capacity=plan["capacity"],
        sr_slabs=plan["sr_slabs"], sr_entries=256))
    assert np.all(np.isfinite(a_trunc))


def test_sr_worklist_count_independent_of_slab_padding():
    """Review fix: windows reaching past the last real cell id must NOT
    sweep in the empty padding slabs (pinned at the n_cells sentinel) —
    that made n_e grow with sr_slabs table padding, so a measured
    suggest_sr_plan could overflow e_max on the very state it was sized
    from, silently dropping real t-major tail entries."""
    from nbody_tpu.init import make_state

    st = make_state(12288, distribution="reference", seed=3)
    plan = pm.suggest_sr_plan(st.pos, st.mass, 64, 4)
    # Plans are sized for the active worklist — pack the one the
    # production solver would realize for this plan.
    sym = pm.SR_SYMMETRIC
    base = pm.sr_pack_inputs(st.pos, st.mass, grid=64, cutoff_cells=4,
                             sr_slabs=plan["sr_slabs"],
                             sr_entries=plan["sr_entries"],
                             symmetric=sym)
    # the realized production worklist fits the plan it was measured for
    assert int(base["n_e"]) <= base["e_max"], (int(base["n_e"]),
                                               base["e_max"])
    # and the overflow guard agrees: zero on the very state it was
    # sized from
    assert pm.sr_entry_overflow(st.pos, st.mass, 64, 4,
                                capacity=plan["capacity"],
                                sr_slabs=plan["sr_slabs"],
                                sr_entries=plan["sr_entries"]) == 0
    # and the count is a property of the DATA, not of the table padding
    padded = pm.sr_pack_inputs(st.pos, st.mass, grid=64, cutoff_cells=4,
                               sr_slabs=2 * plan["sr_slabs"],
                               sr_entries=4 * plan["sr_entries"],
                               symmetric=sym)
    assert int(padded["n_e"]) == int(base["n_e"])


def test_suggest_sr_plan_per_layout_sizing():
    """suggest_sr_plan sizes sr_entries for the worklist it is asked for
    (default: the module's SR_SYMMETRIC): the symmetric worklist carries
    fewer entries than the full one, and a symmetric plan reproduces the
    full-plan forces when run with the symmetric sweep."""
    pos, _, mass = plummer(4096, seed=5)
    full = pm.suggest_sr_plan(pos, mass, 64, 4, symmetric=False)
    sym = pm.suggest_sr_plan(pos, mass, 64, 4, symmetric=True)
    assert sym["sr_entries"] <= full["sr_entries"]
    assert pm.suggest_sr_plan(pos, mass, 64, 4) == (
        sym if pm.SR_SYMMETRIC else full)
    prev = pm.SR_SYMMETRIC
    try:
        pm.SR_SYMMETRIC = True
        a_sym = np.asarray(pm.accelerations(pos, mass, grid=64,
                                            cutoff_cells=4, **sym))
        pm.SR_SYMMETRIC = False
        a_full = np.asarray(pm.accelerations(pos, mass, grid=64,
                                             cutoff_cells=4, **full))
    finally:
        pm.SR_SYMMETRIC = prev
    scale = np.abs(a_full).max()
    np.testing.assert_allclose(a_sym, a_full, rtol=0, atol=3e-5 * scale)


def test_sr_entry_overflow_guard():
    """The runtime guard behind per-layout plan sizing: zero on the
    state a plan was measured from, positive when the static
    sr_entries would drop live worklist entries, zero for the
    guaranteed (sr_entries=0) bounds."""
    pos, _, mass = plummer(4096, seed=6)
    plan = pm.suggest_sr_plan(pos, mass, 64, 4)
    assert pm.sr_entry_overflow(pos, mass, 64, 4, **plan) == 0
    starved = dict(plan, sr_entries=64)
    over = pm.sr_entry_overflow(pos, mass, 64, 4, **starved)
    assert over > 0
    assert pm.sr_entry_overflow(pos, mass, 64, 4,
                                capacity=plan["capacity"]) == 0


def test_engine_replans_on_entry_overflow():
    """simulation._check_sr_health treats dropped worklist entries as
    plan degradation: under --pm-replan a starved pinned sr_entries
    plan grows after the first sample block."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.models.gravity import make_accel_fn
    from nbody_tpu.simulation import _DeviceRunner

    cfg = SimConfig(n=2048, nsteps=4, sfreq=2, kernel="p3m", pm_grid=64,
                    pm_cutoff=4, distribution="plummer", dt=1e-6,
                    pm_replan=True)
    sim = _DeviceRunner(cfg)
    sim.prepare()
    plan_full = pm.suggest_sr_plan(sim.state.pos, sim.state.mass, 64, 4,
                                   symmetric=False)
    # Starve the plan mid-flight (as clustering drift would) and let
    # the per-block health check catch and regrow it.
    cfg.pm_sr_entries = 64
    sim._blocks.clear()
    sim.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())
    sim._check_sr_health()
    assert cfg.pm_sr_entries > 64
    assert cfg.pm_sr_entries <= plan_full["sr_entries"]


def test_p3m_overflow_momentum_symmetric():
    """Round-3 fix: capacity-overflowed particles fall back to
    mesh-quality forces on BOTH sides of each pair (complement-kernel
    deposit as sources, complement-of-binned gather as targets), so
    momentum stays closed even under heavy overflow."""
    pos, _, mass = plummer(2048, seed=9)
    assert float(pm.cell_overflow_fraction(pos, mass, 64, 4, 16)) > 0.05
    a = np.asarray(pm.accelerations(pos, mass, grid=64, cutoff_cells=4,
                                    capacity=16))
    flux = np.abs((mass[None, :] * a).sum(axis=1))
    scale = np.abs(mass[None, :] * a).sum()
    assert np.all(flux < 1e-4 * scale), (flux / scale)


def _packed_sweep_inputs(n=2048, ng=64, cutoff=4, seed=11,
                         symmetric=False, sr_slabs=0):
    """Short-range packing via the solver's own recipe (pm.sr_pack_inputs
    — the shared seam, so the sweeps are compared in exactly the
    configuration the production solver runs)."""
    pos, _, mass = plummer(n, seed=seed)
    cap = pm.suggest_capacity(pos, mass, ng, cutoff)
    pk = pm.sr_pack_inputs(pos, mass, grid=ng, cutoff_cells=cutoff,
                           capacity=cap, symmetric=symmetric,
                           sr_slabs=sr_slabs)
    return (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], pk["n_e"],
            pk["e_max"], pk["rc2"])


def _occupied(mtab):
    """Columns backed by a binned particle.  Empty slots sit at (0,0,0)
    with zero mass: harmless to every real force, but as targets or
    reaction recipients they accumulate variant-specific garbage (the
    beyond-window => zero-taper guarantee only holds inside cells), and
    the solver never gathers them — so table comparisons must not
    either."""
    return np.asarray(mtab) > 0


def test_p3m_differentiable_grad():
    """differentiable=True: (a) forward values match the default path
    exactly (the static-bound sweep's extra sentinel chunks add literal
    zeros); (b) the sweep's reverse-mode gradient matches an
    independent no-loop dense formulation of the same worklist math;
    (c) jax.grad flows through the FULL p3m solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    pos, _, mass = plummer(256, seed=15)
    pos = jnp.asarray(pos, jnp.float32)
    mass = jnp.asarray(mass, jnp.float32)
    kw = dict(grid=16, cutoff_cells=4, capacity=64)

    a_def = np.asarray(pm.accelerations(pos, mass, **kw))
    a_dif = np.asarray(pm.accelerations(pos, mass, differentiable=True,
                                        **kw))
    np.testing.assert_array_equal(a_dif, a_def)

    ptab, mtab, wl_t, wl_s, n_e, e_max, rc2 = _packed_sweep_inputs(
        n=256, ng=16, seed=15)
    s1 = ptab.shape[1] // pm.SLAB

    def dense(pt):
        p = pt.reshape(3, s1, pm.SLAB)
        m = mtab.reshape(s1, pm.SLAB)
        d = (p[:, wl_s][:, :, None, :] - p[:, wl_t][:, :, :, None])
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        u = jax.lax.rsqrt(r2 + jnp.float32(pm.SOFTENING_SQUARED))
        w = (m[wl_s][:, None, :] * (1.0 - pm._taper(r2 / rc2))
             * (u * u * u))
        contrib = (w[None] * d).sum(axis=3)
        return jnp.zeros((3, s1, pm.SLAB)).at[:, wl_t].add(
            contrib).reshape(3, -1)

    def loss_sweep(pt):
        a = pm._sr_sweep(pt, mtab, wl_t, wl_s, n_e, rc2,
                         static_bound=True)
        return jnp.sum(a * a)

    def loss_dense(pt):
        a = dense(pt)
        return jnp.sum(a * a)

    g_sweep = np.asarray(jax.grad(loss_sweep)(ptab))
    g_dense = np.asarray(jax.grad(loss_dense)(ptab))
    scale = np.abs(g_dense).max()
    np.testing.assert_allclose(g_sweep, g_dense, rtol=0,
                               atol=1e-5 * scale)

    def full_loss(p):
        a = pm.accelerations(p, mass, differentiable=True, **kw)
        return jnp.mean(a * a)

    g = np.asarray(jax.jit(jax.grad(full_loss))(pos))
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0


def test_sr_differentiable_primal_identity():
    """differentiable=True changes only how the short-range loop is
    bounded (static, so AD can cross it): the primal is bit-identical to
    the production traced-bound sweep, for the full and the symmetric
    worklist, and jax.grad flows under both."""
    import jax
    import jax.numpy as jnp

    pos, _, mass = plummer(1024, seed=22)
    pos = jnp.asarray(pos, jnp.float32)
    mass = jnp.asarray(mass, jnp.float32)
    kw = dict(grid=32, cutoff_cells=4,
              capacity=pm.suggest_capacity(pos, mass, 32, 4))

    def loss(p):
        return jnp.mean(pm.accelerations(p, mass, differentiable=True,
                                         **kw) ** 2)

    prev = pm.SR_SYMMETRIC
    grads = {}
    try:
        for sym in (False, True):
            pm.SR_SYMMETRIC = sym
            a_nd = np.asarray(pm.accelerations(pos, mass, **kw))
            a_d = np.asarray(pm.accelerations(pos, mass,
                                              differentiable=True, **kw))
            np.testing.assert_array_equal(a_d, a_nd)
            grads[sym] = np.asarray(jax.jit(jax.grad(loss))(pos))
    finally:
        pm.SR_SYMMETRIC = prev
    scale = np.abs(grads[False]).max()
    assert np.isfinite(grads[True]).all() and scale > 0
    np.testing.assert_allclose(grads[True], grads[False], rtol=0,
                               atol=2e-5 * scale)


def test_p3m_forward_mode_via_xla_impl():
    """Forward-mode AD (jax.jvp) crosses the P3M short-range pass (the
    static-bound sweep), and the jvp agrees with the vjp-transposed
    gradient to fp32 noise."""
    import jax
    import jax.numpy as jnp

    pos, _, mass = plummer(512, seed=23)
    pos = jnp.asarray(pos, jnp.float32)
    mass = jnp.asarray(mass, jnp.float32)
    kw = dict(grid=32, cutoff_cells=4,
              capacity=pm.suggest_capacity(pos, mass, 32, 4))

    def loss(p):
        return jnp.mean(pm.accelerations(p, mass, differentiable=True,
                                         **kw) ** 2)

    tan = jnp.asarray(np.random.default_rng(5).normal(
        size=pos.shape), jnp.float32)
    _, jvp_val = jax.jit(lambda p, t: jax.jvp(loss, (p,), (t,)))(
        pos, tan)
    g = jax.jit(jax.grad(loss))(pos)
    jvp_val = float(jvp_val)
    dot = float(jnp.vdot(g, tan))
    assert np.isfinite(jvp_val) and abs(jvp_val) > 0
    np.testing.assert_allclose(jvp_val, dot, rtol=1e-4)


def test_sr_sweep_symmetric_matches_full():
    """The pair-symmetric worklist (s >= t) + per-entry reaction must
    reproduce the full both-directions sweep: same physics, half the
    entries, also with chunk-boundary-spanning runs."""
    import numpy as np

    full = _packed_sweep_inputs(seed=16)
    sym = _packed_sweep_inputs(seed=16, symmetric=True)
    ptab, mtab, wl_t, wl_s, n_e, e_max, rc2 = full
    _, _, wt_s, ws_s, ne_s, _, _ = sym
    occ = _occupied(mtab)
    assert int(ne_s) < int(n_e)  # genuinely fewer entries
    a_full = np.asarray(pm._sr_sweep(ptab, mtab, wl_t, wl_s, n_e,
                                     rc2))[:, occ]
    a_sym = np.asarray(pm._sr_sweep(ptab, mtab, wt_s, ws_s, ne_s, rc2,
                                    symmetric=True))[:, occ]
    scale = np.abs(a_full).max()
    np.testing.assert_allclose(a_sym, a_full, rtol=0, atol=2e-5 * scale)
    a_sym_c = np.asarray(pm._sr_sweep(ptab, mtab, wt_s, ws_s, ne_s, rc2,
                                      chunk=96, symmetric=True))[:, occ]
    np.testing.assert_allclose(a_sym_c, a_full, rtol=0, atol=2e-5 * scale)


def test_sr_symmetric_knob_end_to_end():
    """pm.SR_SYMMETRIC=True through the FULL p3m solve (plan suggestion
    + packed sweep) must agree with the default to summation-order
    tolerance and keep momentum closed."""
    import numpy as np

    pos, _, mass = plummer(2048, seed=17)
    kw = dict(grid=64, cutoff_cells=4)
    prev = pm.SR_SYMMETRIC
    try:
        pm.SR_SYMMETRIC = False
        plan = pm.suggest_sr_plan(pos, mass, 64, 4)
        a_ref = np.asarray(pm.accelerations(pos, mass, **kw, **plan))
        pm.SR_SYMMETRIC = True
        # Plans are sized for the active worklist (the symmetric one
        # keeps ~half the entries); a later bigger-worklist trace is
        # guarded at runtime by pm.sr_entry_overflow.
        plan_s = pm.suggest_sr_plan(pos, mass, 64, 4)
        assert plan_s["sr_entries"] <= plan["sr_entries"]
        a_sym = np.asarray(pm.accelerations(pos, mass, **kw, **plan_s))
    finally:
        pm.SR_SYMMETRIC = prev
    scale = np.abs(a_ref).max()
    np.testing.assert_allclose(a_sym, a_ref, rtol=0, atol=3e-5 * scale)
    flux = np.abs((mass[None, :] * a_sym).sum(axis=1))
    assert np.all(flux < 1e-4 * np.abs(mass[None, :] * a_sym).sum())


@pytest.mark.parametrize("dist,n,ng,seed", [
    ("plummer", 1024, 32, 3),
    ("plummer", 3072, 64, 4),       # non-power-of-two N
    ("cold_sphere", 2048, 32, 5),   # collapsing shell
    ("uniform", 2048, 32, 6),       # near-empty cell list tails
])
def test_sr_sweep_variants_fuzz(dist, n, ng, seed):
    """The symmetric worklist and sweep against the full one, over a
    spread of distributions, sizes, grids and chunk widths — occupied
    slots only (empty slots are never gathered)."""
    rng = np.random.default_rng(seed)
    if dist == "plummer":
        pos, _, mass = plummer(n, seed=seed)
    elif dist == "cold_sphere":
        pos, _, mass = cold_sphere(n, seed=seed)
    else:
        pos = rng.random((3, n)).astype(np.float32)
        mass = rng.random(n).astype(np.float32) * 1e5
    cap = pm.suggest_capacity(pos, mass, ng, 4)

    def pack(**kw):
        return pm.sr_pack_inputs(pos, mass, grid=ng, cutoff_cells=4,
                                 capacity=cap, **kw)

    full = pack()
    occ = _occupied(full["mtab"])
    a_ref = np.asarray(pm._sr_sweep(
        full["ptab"], full["mtab"], full["wl_t"], full["wl_s"],
        full["n_e"], full["rc2"]))[:, occ]
    scale = max(np.abs(a_ref).max(), 1e-30)
    sym = pack(symmetric=True)
    assert int(sym["n_e"]) <= int(full["n_e"])
    for chunk in (128, 512):
        a = np.asarray(pm._sr_sweep(
            full["ptab"], full["mtab"], sym["wl_t"], sym["wl_s"],
            sym["n_e"], sym["rc2"], chunk=chunk, symmetric=True))[:, occ]
        np.testing.assert_allclose(a, a_ref, rtol=0, atol=4e-5 * scale,
                                   err_msg=f"chunk={chunk}")


def test_make_accel_fn_mesh_tiers_native_ad():
    """make_accel_fn('p3m', differentiable=True) must use the native AD
    path (static-bound sweep), NOT the exact-pair analytic VJP — a mesh
    forward with all-pairs cotangents would silently mismatch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbody_tpu.models.gravity import make_accel_fn

    pos, _, mass = plummer(256, seed=18)
    pos = jnp.asarray(pos, jnp.float32)
    mass = jnp.asarray(mass, jnp.float32)
    fn = make_accel_fn("p3m", differentiable=True, grid=16, capacity=64)

    def loss(p):
        a = fn(p, mass)
        return jnp.mean(a * a)

    g = np.asarray(jax.jit(jax.grad(loss))(pos))
    want = np.asarray(jax.grad(
        lambda p: jnp.mean(pm.accelerations(
            p, mass, grid=16, cutoff_cells=4, capacity=64,
            differentiable=True) ** 2))(pos))
    np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-8)


def test_suggest_capacity_data_driven():
    pos, _, mass = plummer(2048, seed=1)
    cap = pm.suggest_capacity(pos, mass, 128, 4)
    assert cap >= 64 and (cap & (cap - 1)) == 0  # pow2, >= floor
    occ = int(pm._max_occupancy(pos, mass, 128, 4))
    assert cap >= occ  # no overflow at the suggested size
    # compact uniform ICs need only the floor
    pos2, _, mass2 = cold_sphere(1024, seed=2)
    assert pm.suggest_capacity(pos2, mass2, 64, 4) == 64


def test_p3m_engine_run():
    """End-to-end: --kernel p3m through the engine (capacity auto-sized
    from the initial state), finite trace."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=512, nsteps=20, sfreq=10, kernel="p3m", pm_grid=32,
                    distribution="plummer", dt=0.01)
    result = run(cfg, quiet=True)
    assert cfg.pm_capacity >= 64  # the engine sized the cell list
    assert len(result.samples) == 2
    assert all(np.isfinite(ke) for _, ke in result.kenergy_trace)


# ---------------------------------------------------------------------------
# Periodic P3M (ghost images; ops/pm.py _periodic_p3m_between)
# ---------------------------------------------------------------------------


def _corner_blob(n=96, seed=5):
    """Gaussian blob wrapped around a box CORNER: every particle sits
    near faces in all three axes, so min-image neighbor pairs cross the
    boundary in 1, 2 and 3 axes at once — the adversarial case for the
    ghost-image machinery."""
    rng = np.random.default_rng(seed)
    pos = np.asarray((0.06 * rng.standard_normal((3, n))) % 1.0,
                     np.float32)
    mass = np.asarray(1.0 + rng.random(n), np.float32)
    return pos, mass


def _periodic_exact(pos, mass, box, kmax=48):
    """fp64 direct Fourier-series sum (scipy Bessel) — the independent
    periodic ground truth; see tests/test_pm.py::_kspace_reference."""
    import scipy.special as sp

    L = float(box)
    eps = np.sqrt(1e-3)
    G = 6.67259e-11
    p = pos.astype(np.float64)
    m = mass.astype(np.float64)
    n1 = np.arange(-kmax, kmax + 1)
    ky, kz = np.meshgrid(2 * np.pi / L * n1, 2 * np.pi / L * n1,
                         indexing="ij")
    acc = np.zeros((3, p.shape[1]))
    for nx in n1:
        kx = 2 * np.pi / L * nx
        kvec = np.stack([np.full_like(ky, kx), ky, kz]).reshape(3, -1)
        k2 = (kvec ** 2).sum(axis=0)
        kk = np.where(k2 > 0, np.sqrt(k2), 1.0)
        phih = np.where(k2 > 0, 4 * np.pi * eps * sp.k1(kk * eps) / kk,
                        0.0)
        rho = (m[None, :] * np.exp(-1j * kvec.T @ p)).sum(axis=1)
        wave = np.exp(1j * kvec.T @ p)
        coef = 1j * kvec * (phih * rho)[None, :]
        acc += (coef @ wave).real
    return G / L ** 3 * acc


def test_ghost_images_cover_min_image_pairs():
    """Every within-R_c min-image pair must have a DIRECT counterpart
    against the augmented (real + ghost) source set, at exactly the
    min-image displacement — the property that lets the open-boundary
    sweep kernels run unchanged."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    pos = np.asarray(rng.random((3, 128)), np.float32)
    mass = np.asarray(1.0 + rng.random(128), np.float32)
    rc = 0.15
    gpos, gmass, n_g = pm._ghost_images(jnp.asarray(pos),
                                        jnp.asarray(mass), 1.0,
                                        jnp.float32(rc), 7 * 128)
    n_g = int(n_g)
    aug = np.concatenate([pos, np.asarray(gpos)[:, :n_g]], axis=1)
    d = pos[:, :, None] - pos[:, None, :]  # direct (3, N, N)
    dmin = d - np.round(d)  # min image on the unit box
    r2 = (dmin ** 2).sum(axis=0)
    da = aug[:, None, :] - pos[:, :, None]  # (3, N, N+G) src - tgt
    for i, j in zip(*np.where((r2 < rc * rc) & (r2 > 0))):
        want = -dmin[:, i, j]  # x_src_image - x_tgt
        hit = np.abs(da[:, i, :] - want[:, None]).max(axis=0) < 1e-6
        assert hit.any(), (i, j, want)
    # count matches the per-axis sign construction
    sig = (pos < rc).astype(int) - (pos > 1.0 - rc).astype(int)
    expect = int((np.prod(1 + np.abs(sig), axis=0) - 1).sum())
    assert n_g == expect
    assert np.all(np.asarray(gmass)[:n_g] > 0)


def test_ghost_images_multiset_and_truncation():
    """The packed image MULTISET equals the brute-force enumeration
    (every massive boundary particle x every admissible nonempty shift
    combo), and a truncating gcap still packs exactly gcap live images
    while n_ghost stays the exact total — pins the two-stage
    boundary-compaction decode (_ghost_images / _GHOST_COMBO_TABLE)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    n = 256
    pos = np.asarray(rng.random((3, n)), np.float32)
    mass = np.asarray(1.0 + rng.random(n), np.float32)
    mass[:: 9] = 0.0  # padding particles never ghost
    rc = 0.2
    # Brute-force reference multiset of (x, y, z, m) image rows.
    sig = (pos < rc).astype(int) - (pos > 1.0 - rc).astype(int)
    want = []
    for i in range(n):
        if mass[i] <= 0:
            continue
        for c in pm._GHOST_COMBOS:
            cv = np.asarray(c)
            if np.all((cv != 1) | (sig[:, i] != 0)):
                sh = np.where(cv == 1, sig[:, i], 0).astype(np.float32)
                want.append([*(pos[:, i] + sh), mass[i]])
    want = np.asarray(sorted(map(tuple, want)), np.float32)

    gpos, gmass, n_g = pm._ghost_images(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, jnp.float32(rc),
        7 * n)
    assert int(n_g) == len(want)
    live = np.asarray(gmass) > 0
    got = np.concatenate(
        [np.asarray(gpos)[:, live], np.asarray(gmass)[None, live]]).T
    got = np.asarray(sorted(map(tuple, got)), np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got, want)

    gcap = len(want) // 2  # force truncation
    gpos2, gmass2, n_g2 = pm._ghost_images(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, jnp.float32(rc), gcap)
    assert int(n_g2) == len(want)  # exact count survives truncation
    live2 = np.asarray(gmass2) > 0
    assert int(live2.sum()) == gcap  # every slot packed
    got2 = np.concatenate(
        [np.asarray(gpos2)[:, live2], np.asarray(gmass2)[None, live2]]).T
    want_set = set(map(tuple, want))
    assert all(tuple(r) in want_set for r in np.asarray(got2, np.float32))


def test_p3m_periodic_vs_kspace_sum():
    """The headline: on a corner-wrapped blob (boundary-crossing close
    pairs) periodic P3M lands near its mesh floor while plain periodic
    PM keeps CIC-scale error; both measured against the independent
    k-space sum."""
    pos, mass = _corner_blob()
    a_ref = _periodic_exact(pos, mass, 1.0)

    def err(a):
        return np.linalg.norm(a - a_ref) / np.linalg.norm(a_ref)

    for ng, bound in ((32, 2.5e-2), (64, 1.5e-2)):
        plan = pm.suggest_sr_plan(pos, mass, ng, 4, boundary="periodic",
                                  box_size=1.0)
        a = np.asarray(pm.accelerations(
            pos, mass, grid=ng, cutoff_cells=4, boundary="periodic",
            box_size=1.0, **plan))
        e_p3m = err(a)
        e_pm = err(np.asarray(pm.accelerations(
            pos, mass, grid=ng, boundary="periodic", box_size=1.0)))
        assert e_p3m < bound, (ng, e_p3m)
        assert e_p3m < e_pm / 3, (ng, e_pm, e_p3m)


def test_p3m_periodic_boundary_pair_exact():
    """A close pair straddling a face: P3M recovers the exact min-image
    force (CIC-floor residual); plain periodic PM misses it badly."""
    pos = np.array([[0.01, 0.99], [0.5, 0.5], [0.5, 0.5]], np.float32)
    mass = np.array([2.0, 3.0], np.float32)
    G, eps2 = 6.67259e-11, 1e-3
    d = np.array([-0.02, 0.0, 0.0])
    exact = G * mass[1] * d * (d[0] ** 2 + eps2) ** -1.5
    a = np.asarray(pm.accelerations(pos, mass, grid=32, cutoff_cells=4,
                                    boundary="periodic", box_size=1.0))
    a_pm = np.asarray(pm.accelerations(pos, mass, grid=32,
                                       boundary="periodic", box_size=1.0))
    assert abs(a[0, 0] - exact[0]) < 0.05 * abs(exact[0]), (a[:, 0], exact)
    assert abs(a_pm[0, 0] - exact[0]) > 0.3 * abs(exact[0])  # pm can't


def test_p3m_periodic_momentum_conserved():
    """Ghost images carry real mass, so the reaction bookkeeping must
    still close: sum m*a ~ 0 on the adversarial corner blob."""
    pos, mass = _corner_blob(seed=9)
    plan = pm.suggest_sr_plan(pos, mass, 32, 4, boundary="periodic",
                              box_size=1.0)
    a = np.asarray(pm.accelerations(pos, mass, grid=32, cutoff_cells=4,
                                    boundary="periodic", box_size=1.0,
                                    **plan))
    p_dot = (mass * a).sum(axis=1)
    scale = np.abs(mass[None, :] * a).sum(axis=1) + 1e-30
    assert np.all(np.abs(p_dot) / scale < 1e-4), p_dot / scale


def test_p3m_periodic_plan_measured():
    """suggest_sr_plan with periodic boundaries measures the ghost count
    (sr_ghosts key) and a capacity covering the ghost-extended grid;
    cell_overflow_fraction then reports zero."""
    pos, mass = _corner_blob(seed=11)
    plan = pm.suggest_sr_plan(pos, mass, 32, 4, boundary="periodic",
                              box_size=1.0)
    assert plan["sr_ghosts"] >= 64
    assert plan["sr_ghosts"] <= 7 * pos.shape[1]
    over = float(pm.cell_overflow_fraction(
        pos, mass, 32, 4, capacity=plan["capacity"],
        boundary="periodic", box_size=1.0))
    assert over == 0.0
    # starved defaults on this blob are measurably worse than the plan
    a_ref = _periodic_exact(pos, mass, 1.0)

    def err(a):
        return np.linalg.norm(a - a_ref) / np.linalg.norm(a_ref)

    kw = dict(grid=32, cutoff_cells=4, boundary="periodic", box_size=1.0)
    e_plan = err(np.asarray(pm.accelerations(pos, mass, **kw, **plan)))
    assert e_plan < 2.5e-2, e_plan


def test_periodic_overflow_diag_uses_solver_capacity():
    """cell_overflow_fraction's capacity=0 baseline must resolve the
    SAME default capacity as the solver's _sr_sizing.  Periodic solves
    bin on the ghost-extended grid, whose larger cell count auto-sizes
    a SMALLER cap (N=65536, grid=32: cap=64 on 20^3 cells vs 128 on the
    core 16^3) — sizing the diagnostic from the core grid once reported
    0.0 while the actual run dropped particles to mesh-quality
    forces."""
    rng = np.random.default_rng(5)
    n = 65536
    pos = rng.uniform(0, 1, size=(3, n)).astype(np.float32)
    # 100 particles piled into one interior cell: over the solver's
    # auto cap (64) but under the core-grid cap (128) the diagnostic
    # previously used.  0.53125 is a CELL CENTER of the ghost-extended
    # grid (lo=-0.125, cs=0.0625) — 0.5 would be a cell boundary and
    # split the pile 8 ways.
    pos[:, :100] = np.float32(0.53125) + np.asarray(
        0.001 * rng.standard_normal((3, 100)), np.float32)
    mass = np.full((n,), 1.0 / n, np.float32)
    kw = dict(boundary="periodic", box_size=1.0)
    over = float(pm.cell_overflow_fraction(pos, mass, 32, 4, 0, **kw))
    assert over > 0.0, "diagnostic must see the solver's cap overflow"
    # ...and a capacity covering the pile reports zero again
    assert float(pm.cell_overflow_fraction(pos, mass, 32, 4, 256,
                                           **kw)) == 0.0


def test_ghost_overflow_count_diag():
    """ghost_overflow_count is the runtime detector for _ghost_images'
    silent drop path (dropped ghosts lose the ENTIRE short-range term
    — worse than cell overflow, which keeps mesh-quality forces)."""
    pos, mass = _corner_blob(seed=7)
    # the guaranteed 7N bound can never overflow
    assert pm.ghost_overflow_count(pos, mass, 32, 4,
                                   sr_ghosts=7 * pos.shape[1],
                                   box_size=1.0) == 0
    # the measured-plan cap is sufficient for the state it measured
    plan = pm.suggest_sr_plan(pos, mass, 32, 4, boundary="periodic",
                              box_size=1.0)
    assert pm.ghost_overflow_count(pos, mass, 32, 4,
                                   sr_ghosts=plan["sr_ghosts"],
                                   box_size=1.0) == 0
    # a deliberately starved cap reports the dropped images
    dropped = pm.ghost_overflow_count(pos, mass, 32, 4, sr_ghosts=8,
                                      box_size=1.0)
    assert dropped > 0, "starved ghost cap must be detected"


def test_p3m_periodic_config_and_cell_validation():
    """Config accepts p3m periodic; the solver rejects R_c >= box/2
    cell geometries instead of silently wrapping the taper onto its
    own images."""
    from nbody_tpu.config import SimConfig

    cfg = SimConfig(kernel="p3m", pm_boundary="periodic", pm_box=2.0,
                    pm_grid=64)
    opts = cfg.kernel_opts()
    assert opts["boundary"] == "periodic" and opts["box_size"] == 2.0
    pos, mass = _corner_blob(seed=3)
    with pytest.raises(ValueError, match="box/2"):
        pm.accelerations(pos, mass, grid=8, cutoff_cells=4,
                         boundary="periodic", box_size=1.0)


def test_periodic_mesh_env_freezes_spectra():
    """Periodic mesh_env (round-5: the round-4 'periodic p3m slower
    than open' anomaly was the env being silently ignored on the
    periodic dispatch): the frozen-spectra step must be EXACT vs the
    in-trace rebuild (the spectra are run constants), for both plain
    pm and p3m, and a boundary/grid-mismatched env must be rejected."""
    pos, mass = _corner_blob(seed=11)
    for cutoff in (0, 4):
        kw = dict(grid=32, cutoff_cells=cutoff, boundary="periodic",
                  box_size=1.0)
        env = pm.make_mesh_env(pos, mass, **kw)
        assert env, "periodic env must carry frozen spectra now"
        spec = env["spectra"]
        leaf = spec[0][0] if cutoff else spec[0]
        assert leaf.shape == (32, 32, 32)  # ng^3, not (2ng)^3
        a_env = np.asarray(pm.accelerations(pos, mass, mesh_env=env,
                                            **kw))
        a_ref = np.asarray(pm.accelerations(pos, mass, **kw))
        # Same arithmetic, but not bit-identical: with the env the
        # spectra arrive as executable INPUTS, without it XLA fuses
        # their build into the spectral multiply and rounds the fused
        # form differently — ulp-level drift only.
        np.testing.assert_allclose(a_env, a_ref, rtol=0,
                                   atol=1e-5 * np.abs(a_ref).max())
    # open env into a periodic call (and vice versa) is a config error
    env_open = pm.make_mesh_env(pos, mass, grid=32, cutoff_cells=4)
    with pytest.raises(ValueError, match="different solver config"):
        pm.accelerations(pos, mass, grid=32, cutoff_cells=4,
                         boundary="periodic", box_size=1.0,
                         mesh_env=env_open)
    env_per = pm.make_mesh_env(pos, mass, grid=32, cutoff_cells=4,
                               boundary="periodic", box_size=1.0)
    with pytest.raises(ValueError, match="different solver config"):
        pm.accelerations(pos, mass, grid=32, cutoff_cells=4,
                         mesh_env=env_per)


def test_p3m_periodic_sweep_variants_agree():
    """SR_SYMMETRIC through the FULL periodic solve agrees with the full
    worklist — the ghost-augmented tables are ordinary packed tables, so
    both worklists must compose."""
    pos, mass = _corner_blob(seed=13)
    kw = dict(grid=32, cutoff_cells=4, boundary="periodic", box_size=1.0)
    # One plan for both worklists: size it for the full one.
    plan = pm.suggest_sr_plan(pos, mass, 32, 4, boundary="periodic",
                              box_size=1.0, symmetric=False)
    prev = pm.SR_SYMMETRIC
    try:
        pm.SR_SYMMETRIC = False
        a_ref = np.asarray(pm.accelerations(pos, mass, **kw, **plan))
        pm.SR_SYMMETRIC = True
        a_sym = np.asarray(pm.accelerations(pos, mass, **kw, **plan))
    finally:
        pm.SR_SYMMETRIC = prev
    scale = np.abs(a_ref).max()
    np.testing.assert_allclose(a_sym, a_ref, rtol=0, atol=3e-5 * scale)


def test_p3m_periodic_differentiable():
    """differentiable=True keeps values identical and lets grad flow
    through the ghost compaction (scatter), wrap, FFTs and the
    static-bound sweep."""
    import jax
    import jax.numpy as jnp

    pos, mass = _corner_blob(n=64, seed=15)
    kw = dict(grid=32, cutoff_cells=4, boundary="periodic", box_size=1.0,
              capacity=256, sr_ghosts=512)
    a0 = np.asarray(pm.accelerations(pos, mass, **kw))
    a1 = np.asarray(pm.accelerations(pos, mass, **kw,
                                     differentiable=True))
    np.testing.assert_array_equal(a0, a1)

    def loss(p):
        a = pm.accelerations(p, jnp.asarray(mass), differentiable=True,
                             **kw)
        return (a * a).sum()

    g = jax.jit(jax.grad(loss))(jnp.asarray(pos))
    assert bool(jnp.isfinite(g).all())
    assert float(jnp.abs(g).max()) > 0


def test_p3m_periodic_sharded_matches_single():
    """Engine-level 1-vs-4 agreement for sharded periodic P3M (mesh
    local-deposit+psum; SR entry chunks split across shards, one table
    psum)."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    kw = dict(n=512, nsteps=50, kernel="p3m", pm_grid=32,
              pm_boundary="periodic", pm_box=8.0)
    res = run(SimConfig(shards=4, comm="allgather", **kw), quiet=True)
    ref = run(SimConfig(**kw), quiet=True)
    for (s, ke), (s_r, ke_r) in zip(res.kenergy_trace, ref.kenergy_trace):
        assert abs(ke - ke_r) <= 1e-4 * max(abs(ke_r), 1e-9), (s, ke, ke_r)


def test_sr_health_warns_on_overflow(capsys):
    """A pinned-tiny capacity overflows immediately; the per-block
    health check reports it ONCE on stderr and the run completes (the
    overflowed pairs degrade to mesh-quality forces, never crash)."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=512, nsteps=100, sfreq=50, kernel="p3m",
                    pm_grid=16, pm_capacity=1)
    result = run(cfg, quiet=True)
    err = capsys.readouterr().err
    assert len(result.samples) == 2
    assert err.count("p3m plan health") == 1
    assert "--pm-replan" in err


def test_sr_health_replan_grows_plan(capsys):
    """--pm-replan re-measures the degraded plan, grows the static
    shapes, and rebuilds the blocks mid-run."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=512, nsteps=150, sfreq=50, kernel="p3m",
                    pm_grid=16, pm_capacity=1, pm_replan=True)
    result = run(cfg, quiet=True)
    err = capsys.readouterr().err
    assert len(result.samples) == 3
    assert "replanned" in err
    assert cfg.pm_capacity > 1
    ke = [s[2] for s in result.samples]
    assert all(np.isfinite(k) for k in ke)


def test_sr_health_quiet_when_healthy(capsys):
    """A measured plan on a static-shape-friendly run emits nothing."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=512, nsteps=50, sfreq=50, kernel="p3m",
                    pm_grid=16)
    run(cfg, quiet=True)
    assert "p3m plan health" not in capsys.readouterr().err


def test_pm_replan_config_validation():
    import pytest

    from nbody_tpu.config import SimConfig

    with pytest.raises(ValueError, match="pm-replan"):
        SimConfig(kernel="naive", pm_replan=True)
    with pytest.raises(ValueError, match="pm-replan"):
        SimConfig(kernel="pm", pm_replan=True)  # no short-range pass
    SimConfig(kernel="pm", pm_cutoff=4, pm_replan=True)
    SimConfig(kernel="p3m", pm_replan=True)


def _cold_lattice(nl: int, box: float = 1.0):
    """nl^3 cold cubic lattice (cell-centered) in the periodic box."""
    q1 = (np.arange(nl) + 0.5) / nl * box
    qx, qy, qz = np.meshgrid(q1, q1, q1, indexing="ij")
    q = np.stack([qx.ravel(), qy.ravel(), qz.ravel()]).astype(np.float32)
    m = np.full((nl ** 3,), 1.0 / nl ** 3, np.float32)  # M=1, rho=1
    return q, m


def test_periodic_linear_response_analytic():
    """Zel'dovich linear response: a cold lattice displaced by
    xi = A sin(k q_x) at the fundamental k = 2 pi / L must feel
    a_x = 4 pi G rho_bar * (k eps) K1(k eps) * xi — the plane-wave
    linear-theory result for the softened Plummer kernel (the
    (k eps) K1(k eps) factor IS the kernel's closed-form spectrum shape,
    validated independently against an fp64 Bessel sum in test_pm).
    This pins the periodic solver's absolute normalization (G, the
    background subtraction, deposit/gather calibration) end-to-end,
    for both the pure mesh and the P3M split (whose taper must
    reassemble the SAME total force)."""
    from nbody_tpu.types import G_NEWTON, SOFTENING_SQUARED

    L = 1.0
    q, m = _cold_lattice(24, L)
    k = np.float32(2 * np.pi / L)
    A = np.float32(0.002)  # linear regime: A*k = 0.013 << 1
    pos = q.copy()
    pos[0] += A * np.sin(k * q[0])
    soft = float(pm._xk1(jnp.float32(k * np.sqrt(SOFTENING_SQUARED))))
    pred = 4 * np.pi * G_NEWTON * 1.0 * soft * A
    n = q.shape[1]
    for cutoff in (0, 4):
        acc = np.asarray(pm.accelerations(
            jnp.asarray(pos), jnp.asarray(m), grid=32,
            cutoff_cells=cutoff, boundary="periodic", box_size=L))
        # amplitude of the sin(k q_x) mode of a_x
        proj = 2.0 / n * np.sum(acc[0] * np.sin(k * q[0]))
        err = abs(proj / pred - 1.0)
        assert err < 1.5e-2, (cutoff, proj, pred, err)
        # transverse components carry no coherent mode
        for c in (1, 2):
            t = 2.0 / n * np.sum(acc[c] * np.sin(k * q[0]))
            assert abs(t) < 0.02 * abs(proj), (cutoff, c, t, proj)


@pytest.mark.slow
def test_periodic_linear_growth_rate():
    """Dynamic completion of the linear-response test: with zero
    initial velocity the mode amplitude must grow as
    D(t) = A cosh(t / tau), tau^-2 = 4 pi G rho_bar (k eps) K1(k eps)
    (the pressureless Jeans growing+decaying pair under the periodic
    solver's uniform-background subtraction).  One full growth time
    under leapfrog, measured 0.23% off cosh(1) at nl=24/ng=32 — this
    exercises solver + integrator + engine block machinery as a
    physical system, not just a force snapshot."""
    from nbody_tpu.models.gravity import make_accel_fn, make_block_fn
    from nbody_tpu.state import ParticleState
    from nbody_tpu.types import G_NEWTON, SOFTENING_SQUARED

    L = 1.0
    q, m = _cold_lattice(24, L)
    n = q.shape[1]
    k = np.float32(2 * np.pi / L)
    A = np.float32(0.002)
    pos = q.copy()
    pos[0] += A * np.sin(k * q[0])
    soft = float(pm._xk1(jnp.float32(k * np.sqrt(SOFTENING_SQUARED))))
    tau = 1.0 / np.sqrt(4 * np.pi * G_NEWTON * soft)
    steps = 50
    blk = jax.jit(make_block_fn(
        make_accel_fn("pm", grid=32, boundary="periodic", box_size=L),
        tau / steps, steps, integrator="leapfrog"))
    st = ParticleState(pos=jnp.asarray(pos),
                       vel=jnp.zeros((3, n), jnp.float32),
                       mass=jnp.asarray(m), n=n)
    out, _ = blk(st)
    xp = np.asarray(out.pos)
    D = 2.0 / n * np.sum((xp[0] - q[0]) * np.sin(k * q[0]))
    growth = D / A
    assert abs(growth / np.cosh(1.0) - 1.0) < 2e-2, growth


def test_sr_health_replan_sharded():
    """The plan health check + --pm-replan also serve SHARDED p3m runs
    (the diagnostics are plain jitted calls over the globally-viewed
    sharded state; replan clears the pm-sub block cache so the next
    sample block rebuilds at the grown static shapes)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=512, nsteps=100, sfreq=50, kernel="p3m",
                    pm_grid=16, pm_capacity=1, pm_replan=True,
                    shards=4)
    result = run(cfg, quiet=True)
    assert len(result.samples) == 2
    assert cfg.pm_capacity > 1
    assert all(np.isfinite(s[2]) for s in result.samples)

def test_mesh_env_freeze_first_step_exact():
    """A mesh_env built from the SAME positions must reproduce the
    per-step solve bit-exactly (same box, same spectra arithmetic) —
    the per-block freeze only diverges once particles drift, and then
    by at most the robust box's 3x expansion slack."""
    pos, _, mass = plummer(2048, seed=3)
    kw = dict(grid=64, cutoff_cells=4)
    plan = pm.suggest_sr_plan(pos, mass, 64, 4)
    env = pm.make_mesh_env(pos, mass, grid=64, cutoff_cells=4)
    a_env = np.asarray(pm.accelerations(pos, mass, **kw, **plan,
                                        mesh_env=env))
    a_ref = np.asarray(pm.accelerations(pos, mass, **kw, **plan))
    np.testing.assert_array_equal(a_env, a_ref)
    # plain pm too (3-spectra env)
    env_pm = pm.make_mesh_env(pos, mass, grid=64)
    np.testing.assert_array_equal(
        np.asarray(pm.accelerations(pos, mass, grid=64, mesh_env=env_pm)),
        np.asarray(pm.accelerations(pos, mass, grid=64)))
    # config-mismatch guard
    with pytest.raises(ValueError, match="different solver config"):
        pm.accelerations(pos, mass, grid=32, cutoff_cells=4,
                         mesh_env=env)
    # periodic env: spectra-only, ng^3 (round 5) — the full periodic
    # freeze/mismatch coverage lives in
    # test_periodic_mesh_env_freezes_spectra.
    env_per = pm.make_mesh_env(pos, mass, grid=32, boundary="periodic",
                               box_size=8.0)
    assert np.asarray(env_per["spectra"][0]).shape == (32, 32, 32)


def test_mesh_env_block_matches_per_step_solve():
    """A 5-step block with the per-block frozen env stays within drift
    tolerance of the exact per-step-box block (the engine's default
    wiring for mesh kernels — simulation._mesh_env_fn)."""
    from nbody_tpu.models.integrators import make_block_fn
    from nbody_tpu.state import ParticleState

    pos, vel, mass = plummer(1024, seed=9)
    state = ParticleState(pos=pos, vel=vel * 0.01, mass=mass, n=1024)
    kw = dict(grid=32, cutoff_cells=4, capacity=64)

    def accel(p, m, mesh_env=None):
        return pm.accelerations(p, m, mesh_env=mesh_env, **kw)

    ref, ke_ref = make_block_fn(accel, 0.01, 5)(state)
    out, ke = make_block_fn(
        accel, 0.01, 5,
        env_fn=lambda p, m: pm.make_mesh_env(p, m, grid=32,
                                             cutoff_cells=4))(state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=0, atol=1e-5 * scale)
    assert float(ke) == pytest.approx(float(ke_ref), rel=1e-4)


def test_engine_skips_env_on_periodic_runs():
    """Round-5 measured decision (DESIGN.md 'Periodic P3M cost
    ledger'): periodic spectra are loop-invariant constants XLA hoists
    inside the block executable, and a cross-executable frozen env
    measured 25-45 ms/step SLOWER at N=1M — the engine must build an
    env for OPEN mesh runs and NONE for periodic ones, and the
    periodic run must still work end-to-end."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import _DeviceRunner, run

    cfg = SimConfig(n=512, nsteps=2, sfreq=2, kernel="p3m", pm_grid=16,
                    pm_boundary="periodic", pm_box=8.0)
    sim = _DeviceRunner(cfg)
    assert sim._mesh_env_fn("p3m") is None
    assert sim._mesh_env_fn("pm") is None
    open_cfg = SimConfig(n=512, nsteps=2, sfreq=2, kernel="p3m",
                         pm_grid=16)
    assert _DeviceRunner(open_cfg)._mesh_env_fn("p3m") is not None
    result = run(cfg, quiet=True)
    assert np.isfinite(result.samples[-1][2])
