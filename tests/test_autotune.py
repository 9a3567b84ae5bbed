"""Autotuner mechanism (timing runs in Pallas interpreter mode on CPU)."""

import numpy as np
import pytest

from nbody_tpu.utils import autotune


def test_autotune_picks_valid_candidate(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    autotune._memory_cache.clear()
    ti, tj = autotune.autotune_tiles(
        256, candidates=[(32, 32), (64, 32)], loops=1, interpret=True,
    )
    assert (ti, tj) in [(32, 32), (64, 32)]
    # disk cache round-trip
    autotune._memory_cache.clear()
    ti2, tj2 = autotune.autotune_tiles(
        256, candidates=[(32, 32)], loops=1, interpret=True
    )
    assert (ti2, tj2) == (ti, tj)


def test_engine_autotune_wiring(tmp_path, monkeypatch):
    # --autotune --interpret must tune and run on CPU (interpret reaches
    # the tuner's candidate timing, not just the final kernel).
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    autotune._memory_cache.clear()
    monkeypatch.setattr(autotune, "DEFAULT_CANDIDATES", ((32, 32), (32, 64)))

    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=128, nsteps=50, kernel="pallas", autotune=True,
                    interpret=True)
    result = run(cfg, quiet=True)
    assert len(result.samples) == 1
    assert (cfg.tile_i, cfg.tile_j) in ((32, 32), (32, 64))


def test_autotune_tiles_fit_any_n(tmp_path, monkeypatch):
    """The kernel pads to whole tiles, so a candidate need not divide N."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    autotune._memory_cache.clear()
    ti, tj = autotune.autotune_tiles(
        200, candidates=[(128, 128)], loops=1, interpret=True
    )
    assert (ti, tj) == (128, 128)


def test_autotune_rejects_non_power_of_two(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    autotune._memory_cache.clear()
    with pytest.raises(ValueError, match="powers of two"):
        autotune.autotune_tiles(256, candidates=[(96, 32)], loops=1,
                                interpret=True)


@pytest.mark.parametrize("tiles", autotune.DEFAULT_CANDIDATES)
def test_default_candidates_are_correct_gpu_tiles(tiles):
    """Every candidate of the forward family is a Triton-legal tile pair
    (powers of two, at most 4 warps of 8-16 pairs per thread) and
    computes the same forces as naive at an N no tile divides."""
    from nbody_tpu.init import reference_init_arrays
    from nbody_tpu.ops import naive, pallas_kernel

    ti, tj = tiles
    assert ti & (ti - 1) == 0 and tj & (tj - 1) == 0
    assert 1 <= pallas_kernel._num_warps(ti, tj) <= 4
    pos, _, mass = reference_init_arrays(200)
    got = np.asarray(pallas_kernel.accelerations(
        pos, mass, tile_i=ti, tile_j=tj, interpret=True))
    want = np.asarray(naive.accelerations(pos, mass))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-6


def test_autotune_online_cycles_and_locks(monkeypatch):
    """--autotune-online: one warm-up + one timed sample block per
    candidate, best locked afterwards; physics identical to a fixed-tile
    run (same kernel math, only tiling switches)."""
    monkeypatch.setattr(autotune, "DEFAULT_CANDIDATES",
                        ((32, 64), (64, 64)))
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=128, nsteps=250, sfreq=50, kernel="pallas",
                    interpret=True, autotune_online=True)
    result = run(cfg, quiet=True)
    assert len(result.samples) == 5
    # after 2 candidates x (warm + timed) = 4 blocks, the 5th ran locked
    assert (cfg.tile_i, cfg.tile_j) in ((32, 64), (64, 64))

    ref = run(SimConfig(n=128, nsteps=250, sfreq=50, kernel="naive"),
              quiet=True)
    for (s, ke), (s_r, ke_r) in zip(result.kenergy_trace, ref.kenergy_trace):
        assert s == s_r and abs(ke - ke_r) <= 1e-5 * max(abs(ke_r), 1e-9)


def test_autotune_online_skips_failing_candidate(monkeypatch):
    """A candidate that fails to compile/run mid-sweep (on hardware: a
    tile that needs more registers or shared memory than a block may
    have) is discarded and the run completes with the surviving
    candidates."""
    from nbody_tpu.ops import pallas_kernel, registry

    real = pallas_kernel.accelerations

    def flaky(pos, mass, **opts):
        if opts.get("tile_i") == 32:
            raise RuntimeError("synthetic compile failure")
        return real(pos, mass, **opts)

    monkeypatch.setitem(
        registry._REGISTRY, "pallas",
        (flaky, pallas_kernel.accelerations_between),
    )
    monkeypatch.setattr(autotune, "DEFAULT_CANDIDATES",
                        ((32, 64), (64, 64)))
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=128, nsteps=250, sfreq=50, kernel="pallas",
                    interpret=True, autotune_online=True)
    result = run(cfg, quiet=True)
    assert len(result.samples) == 5
    assert (cfg.tile_i, cfg.tile_j) == (64, 64)  # survivor locked in

    ref = run(SimConfig(n=128, nsteps=250, sfreq=50, kernel="naive"),
              quiet=True)
    for (s, ke), (s_r, ke_r) in zip(result.kenergy_trace, ref.kenergy_trace):
        assert s == s_r and abs(ke - ke_r) <= 1e-5 * max(abs(ke_r), 1e-9)


def test_autotune_online_retries_transient_failure(monkeypatch):
    """A TRANSIENT failure must not permanently discard the current
    candidate — each candidate gets one retry before being dropped."""
    from nbody_tpu.ops import pallas_kernel, registry

    real = pallas_kernel.accelerations
    calls = {"n32": 0}

    def flaky_once(pos, mass, **opts):
        if opts.get("tile_i") == 32:
            calls["n32"] += 1
            if calls["n32"] == 1:
                raise RuntimeError("synthetic transient failure")
        return real(pos, mass, **opts)

    monkeypatch.setitem(
        registry._REGISTRY, "pallas",
        (flaky_once, pallas_kernel.accelerations_between),
    )
    monkeypatch.setattr(autotune, "DEFAULT_CANDIDATES",
                        ((32, 64), (64, 64)))
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    cfg = SimConfig(n=128, nsteps=250, sfreq=50, kernel="pallas",
                    interpret=True, autotune_online=True)
    result = run(cfg, quiet=True)
    assert len(result.samples) == 5
    # the candidate was retried after the transient failure (called again)
    assert calls["n32"] >= 2


def test_pm_rejects_bf16():
    """Round-2 advisor: '--kernel pm --precision bf16' used to silently
    run fp32 while reporting bf16; it must be rejected."""
    import pytest

    from nbody_tpu.config import SimConfig

    with pytest.raises(ValueError, match="fp32-only"):
        SimConfig(kernel="pm", precision="bf16")
    # the post-construction mutation path is caught too
    cfg = SimConfig(kernel="pm")
    cfg.precision = "bf16"
    with pytest.raises(ValueError, match="fp32-only"):
        cfg.kernel_opts()


def test_autotune_online_sharded(monkeypatch):
    """--autotune-online covers sharded runs too."""
    monkeypatch.setattr(autotune, "DEFAULT_CANDIDATES",
                        ((32, 64), (64, 64)))
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import run

    # 3 blocks: one per candidate, then the lock-in block (interpreted
    # sharded steps cost ~1.5 s each — keep the count minimal).
    cfg = SimConfig(n=260, nsteps=120, sfreq=40, kernel="pallas",
                    shards=4, comm="ring", interpret=True,
                    autotune_online=True)
    result = run(cfg, quiet=True)
    assert len(result.samples) == 3
    assert (cfg.tile_i, cfg.tile_j) in ((32, 64), (64, 64))  # locked

    ref = run(SimConfig(n=260, nsteps=120, sfreq=40, kernel="naive"),
              quiet=True)
    for (s, ke), (s_r, ke_r) in zip(result.kenergy_trace, ref.kenergy_trace):
        assert s == s_r and abs(ke - ke_r) <= 1e-4 * max(abs(ke_r), 1e-9)
