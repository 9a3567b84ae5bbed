"""Pluggable force-kernel registry.

The reference selects among eight compute backends at *link time* — one
Compute.cpp per build (ver5_all/CMakeLists.txt:17,49; ver5_all/Makefile:104).
Here backend selection is a runtime registry keyed by name; all kernels share
the signature ``fn(pos (3,N) f32, mass (N,) f32, **opts) -> acc (3,N) f32``.

Registered kernels:
* ``naive``  — broadcasted jnp, XLA-fused (ver0-2 analog; the reference
  every other kernel is checked against)
* ``pallas`` — tiled GPU pair kernel, Pallas on the Triton route (ver3-8
  analog)
* ``pm``     — particle-mesh FFT solver, O(N log N) approximate far-field
  tier (opt-in; never chosen by ``auto``)
* ``p3m``    — pm plus the exact short-range correction (opt-in)
* ``auto``   — the exact self-kernel for the backend: ``pallas`` on a GPU
  (it beats ``naive`` there at N=16384 and N=1M, PERF.md), ``naive``
  elsewhere (a Triton kernel compiles only for a GPU)
"""

from __future__ import annotations

from typing import Callable, Dict

import jax

from . import naive, pallas_kernel, pm

KernelFn = Callable[..., jax.Array]

# name -> (self_accelerations, accelerations_between)
_REGISTRY: Dict[str, tuple[KernelFn, KernelFn]] = {}


def register(name: str, self_fn: KernelFn, between_fn: KernelFn) -> None:
    _REGISTRY[name] = (self_fn, between_fn)


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY)) + ("auto",)


def resolve(name: str) -> str:
    """Resolve ``auto`` to a concrete kernel name for the default backend."""
    if name != "auto":
        return name
    return "pallas" if jax.default_backend() == "gpu" else "naive"


def get(name: str) -> KernelFn:
    """Self-acceleration kernel: fn(pos (3,N), mass (N,), **opts) -> (3,N)."""
    return _lookup(name)[0]


def get_between(name: str) -> KernelFn:
    """Target/source kernel: fn(pos_tgt, pos_src, mass_src, **opts)."""
    return _lookup(name)[1]


def _lookup(name: str):
    name = resolve(name)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; available: {available()}"
        ) from None


register("naive", naive.accelerations, naive.accelerations_between)
register("pallas", pallas_kernel.accelerations, pallas_kernel.accelerations_between)
# Mesh-based O(N log N) far-field solver (opt-in: approximate, so `auto`
# never selects it — the exact pair kernels are the parity surface).
register("pm", pm.accelerations, pm.accelerations_between)
# P3M: the mesh solver + exact short-range correction within a cutoff
# (cell-list pair pass) — the accurate-on-clustered-ICs tier (opt-in).
register("p3m", pm.p3m_accelerations, pm.p3m_accelerations_between)
