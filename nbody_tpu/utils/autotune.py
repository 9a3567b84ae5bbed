"""Tile autotuning for the tiled pair kernel (ops/pallas_kernel.py).

The reference's only runtime tuner adjusts the OpenCL CPU/GPU work split by
+0.01 per sample block (ver5_all/programming_models/opencl/Compute.cpp:
317-321).  The analog here is tile-size selection, done as an on-device
pre-run sweep over (tile_i, tile_j) powers of two with difference-method
timing (two loop lengths, attributing the difference to the extra
iterations) so fixed dispatch costs cancel.

Results are cached in-process and on disk (``autotune.json`` in the
user's cache directory) keyed by (backend, device kind, padded N, dtype
mode) — per-N entries, so each problem size gets its own tiles.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional, Tuple

import numpy as np

# (tile_i, tile_j) candidates, best-first from the H100 sweep (PERF.md).
# The kernel pads to whole tiles, so every candidate fits every N.
DEFAULT_CANDIDATES: tuple[Tuple[int, int], ...] = (
    (32, 32), (32, 64), (64, 32), (64, 64), (128, 32), (32, 128),
)

_memory_cache: dict = {}


def _cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(base, "nbody_tpu", "autotune.json")


def _load_disk_cache() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_disk_cache(cache: dict) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
    except OSError:
        pass  # caching is best-effort


def _cache_key(n_padded: int, dist_dtype: str) -> str:
    import jax

    dev = jax.devices()[0]
    return f"{jax.default_backend()}|{dev.device_kind}|{n_padded}|{dist_dtype}"


def _diff_time(run, loops: int) -> Optional[float]:
    """Difference-timed seconds per iteration, or None when the candidate
    fails to compile or run."""
    try:
        t1 = run(loops)
        t2 = run(2 * loops)
    except Exception:  # noqa: BLE001 — a rejected candidate is skipped
        return None
    return max(t2 - t1, 1e-9) / loops


def _time_forward(pos, mass, ti, tj, loops, dist_dtype, interpret):
    import jax

    from ..ops.pallas_kernel import accelerations

    def body(_, p):
        acc = accelerations(
            p, mass, tile_i=ti, tile_j=tj, dist_dtype=dist_dtype,
            interpret=interpret,
        )
        return p + np.float32(1e-30) * acc

    def run(k):
        f = jax.jit(lambda p: jax.lax.fori_loop(0, k, body, p))
        f(pos).block_until_ready()
        t0 = time.perf_counter()
        f(pos).block_until_ready()
        return time.perf_counter() - t0

    return _diff_time(run, loops)


def autotune_tiles(
    n_padded: int,
    dist_dtype: str = "float32",
    candidates: Optional[Iterable[Tuple[int, int]]] = None,
    loops: int = 5,
    interpret: bool = False,
    use_disk_cache: bool = True,
    verbose: bool = False,
) -> Tuple[int, int]:
    """Pick the fastest (tile_i, tile_j) for this device, problem size and
    distance dtype."""
    cands = list(candidates or DEFAULT_CANDIDATES)
    for ti, tj in cands:
        if ti < 1 or tj < 1 or ti & (ti - 1) or tj & (tj - 1):
            raise ValueError(f"tile candidate {(ti, tj)} is not a pair "
                             "of powers of two")
    key = _cache_key(n_padded, dist_dtype)
    if key in _memory_cache:
        return tuple(_memory_cache[key])
    disk = _load_disk_cache() if use_disk_cache else {}
    if key in disk:
        _memory_cache[key] = disk[key]
        return tuple(disk[key])

    rng = np.random.default_rng(0)
    pos = np.asarray(rng.random((3, n_padded)), np.float32)
    mass = np.asarray(rng.random(n_padded), np.float32)

    best, best_t = None, float("inf")
    for ti, tj in cands:
        t = _time_forward(pos, mass, ti, tj, loops, dist_dtype, interpret)
        if verbose:
            rate = n_padded * n_padded / t / 1e9 if t else float("nan")
            print(f"  autotune ({ti},{tj}): "
                  + (f"{rate:.1f} Gpairs/s" if t else "failed"))
        if t is not None and t < best_t:
            best, best_t = (ti, tj), t
    if best is None:
        raise RuntimeError("autotune: every candidate tile failed to compile")

    _memory_cache[key] = list(best)
    if use_disk_cache:
        disk[key] = list(best)
        _save_disk_cache(disk)
    return best
