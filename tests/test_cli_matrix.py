"""Combinatorial CLI smoke matrix: flag combinations must wire through the
engine without errors and produce finite energies (tiny configs, CPU)."""

import io
import sys

import pytest

from nbody_tpu.__main__ import main


def _run(args):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = main(args)
    finally:
        sys.stdout = old
    out = buf.getvalue()
    assert rc == 0
    return out


BASE = ["128", "50", "--kernel", "naive"]

MATRIX = [
    BASE,
    BASE + ["--integrator", "leapfrog"],
    BASE + ["--precision", "bf16"],
    BASE + ["--integrator", "leapfrog", "--precision", "bf16"],
    BASE + ["--energy-check"],
    BASE + ["--distribution", "cold_sphere", "--seed", "3", "--dt", "0.01"],
    BASE + ["--distribution", "plummer", "--seed", "5", "--dt", "0.01",
            "--integrator", "leapfrog", "--energy-check"],
    BASE + ["--sfreq", "25"],
    BASE + ["--dt", "0.05"],
    ["64", "50", "--kernel", "naive", "--shards", "8", "--comm", "allgather"],
    ["64", "50", "--kernel", "naive", "--shards", "8", "--comm", "ring",
     "--integrator", "leapfrog"],
    ["64", "50", "--kernel", "naive", "--shards", "8", "--comm", "ring",
     "--precision", "bf16"],
    ["64", "50", "--kernel", "naive", "--shards", "4", "--comm", "allgather",
     "--energy-check"],
    ["128", "50", "--kernel", "pallas", "--interpret",
     "--tile-i", "64", "--tile-j", "128"],
    ["128", "50", "--kernel", "pallas", "--interpret", "--integrator",
     "leapfrog"],
    ["128", "50", "--kernel", "pallas", "--interpret", "--precision",
     "bf16"],
    ["64", "50", "--kernel", "pallas", "--interpret", "--tile-i", "16",
     "--tile-j", "32", "--shards", "8", "--comm", "allgather"],
    ["128", "50", "--kernel", "pallas", "--interpret", "--tile-i", "32",
     "--shards", "4", "--comm", "ring"],
    ["128", "50", "--kernel", "pallas", "--interpret", "--shards", "8",
     "--comm", "ring", "--integrator", "leapfrog"],
    ["64", "50", "--kernel", "pallas", "--interpret", "--shards", "4",
     "--comm", "allgather", "--precision", "bf16"],
]


@pytest.mark.parametrize("argv", MATRIX, ids=lambda a: " ".join(a))
def test_cli_combo(argv):
    out = _run(argv)
    # at least one sample row printed, kenergy value finite
    rows = [l for l in out.splitlines() if l.startswith(" ") and l[1].isdigit()]
    assert rows, out
    ke = float(rows[-1].split()[2])
    assert ke == ke  # not NaN


def test_cli_combo_ref64():
    out = _run(["64", "50", "--precision", "ref64"])
    assert " 50 " in out


@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_sharded_pallas_between(comm):
    # the tiled kernel's between form through both sharded exchanges
    import numpy as np

    from nbody_tpu.init import make_state
    from nbody_tpu.models.gravity import make_accel_fn
    from nbody_tpu.models.integrators import make_block_fn
    from nbody_tpu.parallel.decompose import make_sharded_block_fn, shard_state

    state = make_state(256, pad_multiple=8)
    sharded, mesh = shard_state(state, 8)
    opts = dict(tile_i=16, tile_j=32, interpret=True)
    blk = make_sharded_block_fn("pallas", opts, 0.1, 3, mesh, comm=comm)
    out, ke = blk(sharded)
    ref, ke_ref = make_block_fn(make_accel_fn("naive"), 0.1, 3)(state)
    assert float(ke) == pytest.approx(float(ke_ref), rel=1e-5)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-5, atol=1e-7
    )
