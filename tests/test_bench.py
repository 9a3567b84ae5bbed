"""bench.py and chip_smoke.py: refuse a non-GPU device, and the helpers
that check results on the card."""

import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from nbody_tpu.config import SimConfig  # noqa: E402


def test_bench_refuses_non_gpu(capsys):
    """On the CPU backend bench.main prints exactly one zero-valued JSON
    line naming the device and exits non-zero — never a CPU number."""
    rc = bench.main([])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc != 0
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["value"] == 0.0 and line["device"]["platform"] == "cpu"
    assert "no GPU" in line["error"]


def test_chip_smoke_refuses_non_gpu(capsys):
    """chip_smoke exits non-zero and prints no result without a GPU."""
    rc = chip_smoke.main([])
    captured = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in captured.out
    assert "needs an NVIDIA GPU" in captured.err


def test_chip_smoke_compare_trace():
    golden = [(50, "0.14324"), (100, "1.2345")]
    ok, diffs, max_rel = chip_smoke.compare_trace(
        {50: 0.143241, 100: 1.23449}, golden)
    assert ok and diffs == [] and max_rel < 1e-5
    ok, diffs, max_rel = chip_smoke.compare_trace(
        {50: 0.1433, 100: 1.2345}, golden)
    assert not ok and diffs == [(50, "0.1433", "0.14324")]
    assert max_rel > 1e-4
    ok, diffs, max_rel = chip_smoke.compare_trace({50: 0.14324}, golden)
    assert not ok and diffs == [(100, None, "1.2345")]
    assert math.isinf(max_rel)


def test_chip_smoke_accel64_and_rel_err():
    """The float64 reference agrees with naive (float32) on sampled
    targets, and rel_err is the norm-wise error."""
    from nbody_tpu.init import reference_init_arrays
    from nbody_tpu.ops import naive

    pos, _, mass = reference_init_arrays(300)
    idx = np.array([0, 7, 150, 299])
    ref = chip_smoke.accel64(pos, mass, idx, chunk=3)
    got = np.asarray(naive.accelerations(pos, mass))[:, idx]
    assert chip_smoke.rel_err(got, ref) < 1e-6
    assert chip_smoke.rel_err(ref, ref) == 0.0
    assert chip_smoke.rel_err(2 * ref, ref) == 1.0


def test_chip_smoke_ms_per_step():
    from nbody_tpu.simulation import run

    res = run(SimConfig(n=64, nsteps=4, sfreq=2, kernel="naive"), quiet=True)
    ms = chip_smoke.ms_per_step(res, 2)
    assert ms > 0
    assert math.isclose(ms, 1e3 * np.mean([s[3] for s in res.samples]) / 2)


def test_bench_suite_has_one_executable_rows():
    """No suite row names a removed mode, and every row is a SimConfig
    the engine accepts."""
    for name, precision, n, steps, kernel, *extra in bench.SUITE:
        SimConfig(n=n, nsteps=steps, kernel=kernel or "auto",
                  precision=precision, **(extra[0] if extra else {}))
        assert "fused" not in name


def test_timed_steps_runs():
    cfg = SimConfig(n=128, nsteps=4, kernel="naive")
    assert bench._timed_steps(cfg, 2) > 0
