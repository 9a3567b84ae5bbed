"""CLI surface: positional compatibility with the reference binaries
(ver0/main.cpp:25-46, ver5_all/main.cpp:23-66)."""

import io
import sys

import pytest

from nbody_tpu.__main__ import build_parser, main


def _run_cli(args):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = main(args)
    finally:
        sys.stdout = old
    return rc, buf.getvalue()


def test_defaults_match_reference_ctor():
    args = build_parser().parse_args([])
    assert args.n == 2000 and args.nsteps == 500
    assert args.sfreq == 50 and args.dt == pytest.approx(0.1)


def test_positional_args():
    args = build_parser().parse_args(
        ["4096", "100", "cpu+gpu", "0.5", "128", "256"]
    )
    assert args.n == 4096 and args.nsteps == 100
    assert args.device == "cpu+gpu" and args.cpu_ratio == 0.5
    assert args.dim0 == 128 and args.dim1 == 256


def test_end_to_end_run_output():
    rc, out = _run_cli(["128", "50", "--kernel", "naive"])
    assert rc == 0
    lines = out.splitlines()
    assert lines[0] == "==============================="
    assert lines[1] == " Initialize Gravity Simulation"
    assert " nPart = 128; nSteps = 50; dt = 0.1" in lines
    assert any(l.startswith(" 50 ") for l in lines)
    assert lines[-1] == "==============================="
    assert any(l.startswith("# Number Threads     : ") for l in lines)


def test_device_token_echoed():
    rc, out = _run_cli(["128", "50", "gpu", "--kernel", "naive"])
    assert rc == 0
    assert "gpu" in out.splitlines()


def test_thread_dims_map_to_tiles():
    # dim0/dim1 (the reference's thread dims, ver5_all/main.cpp:51-54)
    # select Pallas tile sizes here.
    from nbody_tpu.config import SimConfig

    cfg = SimConfig(kernel="pallas", tile_i=128, tile_j=256)
    assert cfg.kernel_opts()["tile_i"] == 128
    assert cfg.kernel_opts()["tile_j"] == 256
    # but not the naive kernel (no such options there)
    cfg = SimConfig(kernel="naive", tile_i=128)
    assert "tile_i" not in cfg.kernel_opts()


def test_interpret_reaches_pallas_only():
    """--interpret (and tiles) flow to the Pallas kernel, whether named
    or chosen by auto, and never leak into naive."""
    from nbody_tpu.config import SimConfig

    cfg = SimConfig(kernel="pallas", shards=4, comm="ring",
                    interpret=True, tile_i=64)
    assert cfg.kernel_opts() == {"interpret": True, "tile_i": 64}
    cfg = SimConfig(kernel="naive", interpret=True, tile_i=64)
    assert cfg.kernel_opts() == {}


@pytest.mark.parametrize("argv", [
    ["--kernel", "pallas_sym"], ["--kernel", "pallas_mxu"],
    ["--comm", "rdma"], ["--comm", "ring_sym"], ["--fused"],
    ["--pm-sr-layout", "xla"],
])
def test_removed_options_rejected(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        build_parser().parse_args(["128", "10"] + argv)
    assert exc.value.code == 2


def test_shards_process_divisibility_guard(monkeypatch):
    """--shards not divisible by the process count must fail fast with a
    clear message, not a confusing global-mesh device-count error."""
    import pytest as _pytest

    from nbody_tpu.__main__ import main

    monkeypatch.setenv("NBODY_NUM_PROCESSES", "3")
    with _pytest.raises(SystemExit, match="divisible"):
        main(["128", "1", "--shards", "8", "--platform", "cpu"])


def test_device_selector_semantics():
    """ver5_all/main.cpp:43-45 selector parity: 1=cpu pins the host
    backend, 2/3 select the accelerator."""
    from nbody_tpu.config import SimConfig
    from nbody_tpu.simulation import Simulation

    sim = Simulation(SimConfig(), quiet=True)
    sim.set_devices(1)
    assert sim.config.platform == "cpu"
    sim.set_devices(2)
    assert sim.config.platform is None
    sim.set_devices(3)
    assert sim.config.platform is None


def test_cpu_ratio_emits_note(capsys):
    """cpu_ratio is accepted for CLI parity (ver5_all/main.cpp:49) but a
    device mesh has no CPU/GPU split — the CLI says so instead of silently
    ignoring the flag."""
    rc, out = _run_cli(["128", "50", "gpu", "0.25", "--kernel", "naive"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "cpu_ratio=0.25" in err and "homogeneous" in err
