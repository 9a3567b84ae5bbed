"""Compile-cache placement (utils/platform.enable_compilation_cache)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from nbody_tpu.utils import platform

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_honoured(monkeypatch, tmp_path):
    """An explicit JAX_COMPILATION_CACHE_DIR wins: it is returned and no
    other directory is set in code."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_inside_checkout_and_ignored(monkeypatch,
                                               restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == path
    assert Path(path).parent == ROOT
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert Path(path).name + "/" in ignored


def test_default_path_is_stable():
    """The path is part of the cache key, so it must not vary between
    processes: no pid, time or temporary name."""
    code = ("from nbody_tpu.utils.platform import DEFAULT_CACHE_DIR;"
            "print(DEFAULT_CACHE_DIR)")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    outs = {subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True,
                           check=True).stdout.strip() for _ in range(2)}
    assert outs == {platform.DEFAULT_CACHE_DIR}
    assert str(os.getpid()) not in platform.DEFAULT_CACHE_DIR
