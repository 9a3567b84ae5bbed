"""scripts/pod_run.sh gives each rank its own card (a JAX process
reserves most of the memory of every card it opens).  A stand-in
``python`` on PATH records what each rank was given, so no JAX runs."""

import os
import stat
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("visible,want", [
    (None, ["0", "1", "2", "3"]),
    ("4,5,6,7", ["4", "5", "6", "7"]),
])
def test_pod_run_assigns_one_card_per_rank(tmp_path, visible, want):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "python"
    fake.write_text('#!/bin/sh\necho "$JAX_PROCESS_ID:$CUDA_VISIBLE_DEVICES"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    logs = tmp_path / "logs"
    logs.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    env.update(PATH=f"{bindir}:{env['PATH']}", NBODY_COORDINATOR_PORT="1",
               NBODY_LOG_DIR=str(logs))
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    subprocess.run(["bash", str(ROOT / "scripts" / "pod_run.sh"), "4",
                    "128", "1"], env=env, check=True, timeout=60,
                   capture_output=True)
    got = [(logs / f"rank{i}.out").read_text().strip() for i in range(4)]
    assert got == [f"{i}:{c}" for i, c in enumerate(want)]
