"""Platform selection and compile-cache placement.

``force_cpu`` must be called before any JAX backend is initialized (i.e.
before the first ``jax.devices()``/computation)."""

from __future__ import annotations

import os


def force_cpu(n_virtual_devices: int | None = None) -> None:
    """Route JAX to the host CPU backend, optionally with N virtual devices
    (the way to test multi-device sharding without the devices)."""
    if n_virtual_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        want = f"--xla_force_host_platform_device_count={n_virtual_devices}"
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " " + want).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


# The persistent compile cache lives inside the checkout unless
# JAX_COMPILATION_CACHE_DIR says otherwise: a fixed path, because the
# path is part of the cache's key.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    An explicit ``JAX_COMPILATION_CACHE_DIR`` is honoured as JAX reads
    it; otherwise the cache goes to ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
