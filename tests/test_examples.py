"""Smoke tests for the examples and remaining engine I/O paths."""

import glob
import json
import os
import runpy
import sys

import pytest

from nbody_tpu.config import SimConfig
from nbody_tpu.simulation import run


def _run_example(path, argv):
    old = sys.argv
    sys.argv = [path] + argv
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), f"{path} exited {e.code}"
    finally:
        sys.argv = old


def test_fit_velocities_example(capsys):
    _run_example("examples/fit_velocities.py", ["96", "6", "40"])
    out = capsys.readouterr().out
    assert "recovered initial velocities" in out


def test_ensemble_example(capsys):
    _run_example("examples/ensemble.py", ["4", "128", "5", "naive"])
    out = capsys.readouterr().out
    assert out.count("member ") == 4


def test_ensemble_example_meshed(capsys):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    _run_example("examples/ensemble.py",
                 ["8", "128", "5", "naive", "--mesh"])
    assert "no collectives" in capsys.readouterr().out


def test_render_collapse_example(tmp_path):
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "c.png")
    _run_example("examples/render_collapse.py", ["512", png])
    assert os.path.getsize(png) > 1000


def test_ladder_example(capsys):
    _run_example("examples/ladder.py", ["512", "3", "--interpret"])
    out = capsys.readouterr().out
    assert "naive jnp" in out


def test_pm_crossover_example(capsys):
    _run_example("examples/pm_crossover.py", ["512"])
    out = capsys.readouterr().out
    assert "speedup" in out and "pm rel err" in out


def test_snapshots_and_periodic_checkpoints(tmp_path):
    snapdir = str(tmp_path / "snaps")
    ck = str(tmp_path / "ck.npz")
    run(
        SimConfig(n=64, nsteps=150, kernel="naive", snapshot_every=1,
                  snapshot_dir=snapdir, save_state_path=ck,
                  checkpoint_every=2),
        quiet=True,
    )
    snaps = sorted(glob.glob(os.path.join(snapdir, "step_*.npz")))
    assert [os.path.basename(s) for s in snaps] == [
        "step_000050.npz", "step_000100.npz", "step_000150.npz"
    ]
    assert os.path.exists(ck)


def test_profile_dir(tmp_path):
    pdir = str(tmp_path / "trace")
    run(SimConfig(n=64, nsteps=50, kernel="naive", profile_dir=pdir),
        quiet=True)
    assert os.path.isdir(pdir)


def test_cli_json_file(tmp_path):
    from nbody_tpu.__main__ import main

    path = str(tmp_path / "r.json")
    rc = main(["64", "50", "--kernel", "naive", "--json", path])
    assert rc == 0
    data = json.loads(open(path).read())
    assert len(data["samples"]) == 1
    assert data["samples"][0]["step"] == 50
