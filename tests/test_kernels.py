"""Kernel equivalence: every registered device kernel must agree with the
fp64 oracle forces (single evaluation, tight relative error) and with each
other.  The Pallas kernel runs in interpreter mode on CPU."""

import numpy as np
import pytest

from nbody_tpu.init import reference_init_arrays
from nbody_tpu.oracle import accelerations_ref64
from nbody_tpu.ops import naive, pallas_kernel, registry


def _rel_err(got, want):
    scale = np.abs(want) + np.abs(want).max() * 1e-3
    return np.max(np.abs(got - want) / scale)


@pytest.fixture(scope="module")
def system():
    pos, vel, mass = reference_init_arrays(512)
    acc64 = accelerations_ref64(pos, mass)
    return pos, mass, acc64


def test_naive_matches_oracle(system):
    pos, mass, acc64 = system
    acc = np.asarray(naive.accelerations(pos, mass))
    assert _rel_err(acc, acc64) < 2e-5


def test_naive_chunking_invariance(system):
    pos, mass, _ = system
    a1 = np.asarray(naive.accelerations(pos, mass, chunk=512))
    a2 = np.asarray(naive.accelerations(pos, mass, chunk=128))
    np.testing.assert_allclose(a1, a2, rtol=2e-6, atol=1e-12)


def test_pallas_matches_naive(system):
    pos, mass, _ = system
    want = np.asarray(naive.accelerations(pos, mass))
    got = np.asarray(
        pallas_kernel.accelerations(
            pos, mass, tile_i=128, tile_j=256, interpret=True
        )
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-12)


def test_pallas_matches_oracle(system):
    pos, mass, acc64 = system
    got = np.asarray(
        pallas_kernel.accelerations(
            pos, mass, tile_i=128, tile_j=128, interpret=True
        )
    )
    assert _rel_err(got, acc64) < 2e-5


def test_pallas_tile_invariance(system):
    pos, mass, _ = system
    a1 = np.asarray(
        pallas_kernel.accelerations(pos, mass, tile_i=256, tile_j=512, interpret=True)
    )
    a2 = np.asarray(
        pallas_kernel.accelerations(pos, mass, tile_i=128, tile_j=128, interpret=True)
    )
    np.testing.assert_allclose(a1, a2, rtol=2e-5, atol=1e-12)


def _l2_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_bf16_distance_mode(system):
    pos, mass, acc64 = system
    got = np.asarray(
        naive.accelerations(pos, mass, dist_dtype="bfloat16")
    )
    # bf16 deltas carry ~2.4 decimal digits; individual components with
    # strong cancellation are noisy, but the field error norm stays small.
    assert _l2_rel(got, acc64) < 5e-3
    got_p = np.asarray(
        pallas_kernel.accelerations(
            pos, mass, tile_i=128, tile_j=128, dist_dtype="bfloat16",
            interpret=True,
        )
    )
    assert _l2_rel(got_p, acc64) < 5e-3


def test_registry_names():
    assert set(registry.available()) == {"naive", "pallas", "pm", "p3m",
                                         "auto"}
    assert registry.resolve("auto") in ("naive", "pallas")
    with pytest.raises(KeyError):
        registry.get("bogus")


@pytest.mark.parametrize("backend,want", [("gpu", "pallas"),
                                          ("cpu", "naive")])
def test_auto_resolves_by_backend(monkeypatch, backend, want):
    """auto is the tiled kernel on a GPU (it won at N=16384 and N=1M on
    the card, PERF.md) and naive elsewhere; named kernels pass through."""
    monkeypatch.setattr(registry.jax, "default_backend", lambda: backend)
    assert registry.resolve("auto") == want
    assert registry.get("auto") is registry.get(want)
    assert registry.resolve("naive") == "naive"


@pytest.mark.parametrize("name", ["pallas_sym", "pallas_mxu", "fused"])
def test_removed_kernels_rejected(name):
    with pytest.raises(KeyError, match="unknown kernel"):
        registry.get(name)
    with pytest.raises(KeyError, match="unknown kernel"):
        registry.get_between(name)


def test_between_consistency(system):
    pos, mass, _ = system
    whole = np.asarray(naive.accelerations(pos, mass))
    half = np.asarray(
        naive.accelerations_between(pos[:, :256], pos, mass)
    )
    np.testing.assert_allclose(half, whole[:, :256], rtol=1e-6)


def test_self_interaction_exactly_zero():
    # A single particle exerts no force on itself (dx=0 -> contribution 0),
    # matching the reference's unmasked diagonal (ver0/GSimulation.cpp:132-147).
    pos = np.zeros((3, 1), np.float32)
    mass = np.ones(1, np.float32)
    acc = np.asarray(naive.accelerations(pos, mass, chunk=1))
    assert np.all(acc == 0)


def test_zero_mass_sources_contribute_nothing(system):
    pos, mass, _ = system
    acc_ref = np.asarray(naive.accelerations_between(pos[:, :128], pos, mass))
    pos_aug = np.concatenate([pos, pos[:, :64]], axis=1)  # duplicate positions
    mass_aug = np.concatenate([mass, np.zeros(64, np.float32)])
    acc_aug = np.asarray(
        naive.accelerations_between(pos[:, :128], pos_aug, mass_aug)
    )
    np.testing.assert_array_equal(acc_ref, acc_aug)


def test_momentum_conservation():
    # Sum_i m_i * a_i = 0 for pairwise-antisymmetric forces (the softened
    # kernel is antisymmetric because w_ij depends only on |r_i - r_j|).
    pos, _, mass = reference_init_arrays(256)
    acc = np.asarray(naive.accelerations(pos, mass)).astype(np.float64)
    net = (mass.astype(np.float64)[None, :] * acc).sum(axis=1)
    scale = np.abs(mass[None, :] * acc).sum()
    assert np.all(np.abs(net) < 1e-7 * scale)


def _acc64(pos_t, pos_s, mass_s):
    """Float64 accelerations of targets due to sources (the softened
    force law, diagonal unmasked)."""
    from nbody_tpu.types import G_NEWTON, SOFTENING_SQUARED

    pt = np.asarray(pos_t, np.float64)
    ps = np.asarray(pos_s, np.float64)
    gm = G_NEWTON * np.asarray(mass_s, np.float64)
    d = ps[:, None, :] - pt[:, :, None]
    d2 = (d * d).sum(0) + SOFTENING_SQUARED
    return (d * (gm / d2 ** 1.5)).sum(-1)


@pytest.mark.parametrize("dist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiles", [(32, 32), (64, 32), (32, 128)])
@pytest.mark.parametrize("n", [1, 100, 384, 1000, 2048])
def test_pallas_interpret_vs_fp64(n, tiles, dist_dtype):
    """The tiled kernel in interpret mode against float64, at sizes that
    are and are not multiples of the tiles (zero-mass tail padding)."""
    pos, _, mass = reference_init_arrays(n)
    got = np.asarray(pallas_kernel.accelerations(
        pos, mass, tile_i=tiles[0], tile_j=tiles[1], dist_dtype=dist_dtype,
        interpret=True))
    assert got.shape == (3, n) and got.dtype == np.float32
    if n == 1:
        assert np.all(got == 0)  # the unmasked diagonal is exactly zero
        return
    want = _acc64(pos, pos, mass)
    if dist_dtype == "float32":
        assert _l2_rel(got, want) < 5e-6
    else:
        # Same delta rounding as naive's bf16 mode; only the summation
        # order differs.
        ref = np.asarray(naive.accelerations(pos, mass,
                                             dist_dtype=dist_dtype))
        assert _l2_rel(got, ref) < 2e-6
        assert _l2_rel(got, want) < 5e-3


@pytest.mark.parametrize("nt,ns", [(1, 100), (100, 1), (37, 300),
                                   (300, 37), (64, 128), (129, 1000)])
def test_pallas_between_form(nt, ns):
    """accelerations_between with Nt != Ns (the sharded ring/allgather
    and ensemble primitive) against naive's between form."""
    pos, _, mass = reference_init_arrays(max(nt, ns) + 7)
    pt = pos[:, 7:7 + nt]
    ps, ms = pos[:, :ns], mass[:ns]
    got = np.asarray(pallas_kernel.accelerations_between(
        pt, ps, ms, tile_i=32, tile_j=64, interpret=True))
    assert got.shape == (3, nt)
    np.testing.assert_allclose(got, _acc64(pt, ps, ms), rtol=2e-5,
                               atol=1e-6 * np.abs(_acc64(pt, ps, ms)).max())


def test_pallas_rejects_non_power_of_two_tiles():
    pos, _, mass = reference_init_arrays(64)
    with pytest.raises(ValueError, match="power of two"):
        pallas_kernel.accelerations(pos, mass, tile_i=48, interpret=True)


def test_pallas_zero_mass_padding_force_neutral():
    """Explicit zero-mass sources change nothing, exactly as the kernel's
    own tail padding must not."""
    pos, _, mass = reference_init_arrays(100)
    pos_aug = np.concatenate([pos, pos[:, :28]], axis=1)
    mass_aug = np.concatenate([mass, np.zeros(28, np.float32)])
    a = np.asarray(pallas_kernel.accelerations_between(
        pos, pos, mass, tile_i=32, tile_j=32, interpret=True))
    b = np.asarray(pallas_kernel.accelerations_between(
        pos, pos_aug, mass_aug, tile_i=32, tile_j=32, interpret=True))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,want", [(2000, 2000), (16384, 4096),
                                    (1048576, 64), (4194304, 16)])
def test_naive_chunk_sized_by_bytes(n, want):
    """naive's target chunk keeps one chunk's temporaries under the byte
    budget: the largest divisor of N within it (at N=4M a fixed 1024
    would need 50 GB of deltas)."""
    c = naive.chunk_for(n, n)
    assert c == want
    assert n % c == 0
    assert c * n * naive.TEMP_BYTES_PER_PAIR <= naive.CHUNK_BUDGET_BYTES


def test_naive_contraction_pinned_to_highest():
    """The source sum must not run in TF32 on a GPU: the einsum carries
    Precision.HIGHEST into the lowered program."""
    import jax

    pos, _, mass = reference_init_arrays(64)
    text = jax.jit(naive.accelerations).lower(pos, mass).as_text()
    assert "HIGHEST" in text


@pytest.mark.gpu
def test_pallas_compiled_matches_naive(gpu):
    """The kernel as Triton compiles it for the card (no interpreter),
    against naive; chip_smoke.py checks the same at full size."""
    pos, _, mass = reference_init_arrays(3000)
    got = np.asarray(pallas_kernel.accelerations(pos, mass))
    assert _l2_rel(got, _acc64(pos, pos, mass)) < 5e-6
    want = np.asarray(naive.accelerations(pos, mass))
    assert _l2_rel(got, want) < 2e-6
