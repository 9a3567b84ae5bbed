"""Engine facade, config validation, and driver entry points."""

import pytest

from nbody_tpu.config import SimConfig
from nbody_tpu.simulation import Simulation, run


def test_simulation_facade_mirrors_reference_api(capsys):
    sim = Simulation(SimConfig(n=64, nsteps=50, kernel="naive"))
    sim.set_number_of_particles(128)
    sim.set_number_of_steps(50)
    sim.set_devices(1)          # accepted for reference-CLI parity
    sim.set_cpu_ratio(0.5)      # accepted for reference-CLI parity
    sim.set_thread_dim0(128)    # maps to tile_i
    sim.set_thread_dim1(256)    # maps to tile_j
    assert sim.config.n == 128 and sim.config.tile_i == 128
    result = sim.start()
    out = capsys.readouterr().out
    assert " nPart = 128; nSteps = 50; dt = 0.1" in out
    assert len(result.samples) == 1


def test_init_mpi_single_host_noop():
    sim = Simulation(SimConfig(n=64, nsteps=50, kernel="naive"), quiet=True)
    sim.init_mpi()
    assert sim.world_rank == 0 and sim.world_size == 1


def test_config_validation():
    with pytest.raises(ValueError):
        SimConfig(n=0)
    with pytest.raises(ValueError):
        SimConfig(sfreq=0)
    with pytest.raises(ValueError):
        SimConfig(precision="fp8")
    with pytest.raises(ValueError):
        SimConfig(shards=0)


def test_ref64_mode_through_engine():
    from tests.util import parse_golden_trace
    import os

    from tests.conftest import GOLDEN_DIR

    golden = parse_golden_trace(os.path.join(GOLDEN_DIR, "ver0_n256_s100.txt"))
    result = run(SimConfig(n=256, nsteps=100, precision="ref64"), quiet=True)
    from nbody_tpu.utils.reporting import _g5

    for (s_g, ke_g), (s, ke) in zip(golden, result.kenergy_trace):
        assert s == s_g and _g5(ke) == ke_g


def test_graft_entry_points():
    import sys

    sys.path.insert(0, "/root/repo")
    import jax

    from __graft_entry__ import dryrun_multichip, entry

    fn, args = entry()
    out = jax.jit(fn).lower(*args).compile()
    assert out is not None
    dryrun_multichip(8)  # raises on failure


def test_nsteps_not_multiple_of_sfreq():
    # 120 steps at sfreq=50: two printed blocks + 20 unprinted steps.
    result = run(SimConfig(n=64, nsteps=120, kernel="naive"), quiet=True)
    assert [s for s, _ in result.kenergy_trace] == [50, 100]


@pytest.mark.parametrize("kernel", ["auto", "naive", "pallas", "pm", "p3m"])
def test_pad_multiple_is_shard_count_only(kernel):
    """Every kernel pads its own tiles inside (the tiled kernel pads
    with zero-mass particles), so the state pads only to the shards."""
    assert SimConfig(kernel=kernel).pad_multiple() == 1
    assert SimConfig(kernel=kernel, shards=4).pad_multiple() == 4
    assert SimConfig(kernel=kernel, tile_i=64, tile_j=128,
                     shards=2).pad_multiple() == 2
