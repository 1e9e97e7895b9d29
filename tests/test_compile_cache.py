"""Where the persistent compile cache lives (utils/compile_cache.py)."""

import os
import subprocess
import sys

import jax
import pytest

from watermarking_gpu_tpu.utils import (default_cache_dir,
                                        enable_compilation_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = """
import sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp
from watermarking_gpu_tpu.utils import enable_compilation_cache
print(enable_compilation_cache({arg}, min_compile_seconds=0.0))
jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((32, 32))))
"""


@pytest.fixture()
def restore_cache_config():
    previous = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", previous)


def _compile_in_child(tmp_path, arg: str, env_dir=None) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", _COMPILE.format(repo=REPO, arg=arg)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    return out.stdout.splitlines()[0]


def test_default_dir_is_fixed_inside_the_checkout():
    assert default_cache_dir() == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_env_var_wins_over_a_given_path(tmp_path, monkeypatch,
                                        restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    got = enable_compilation_cache(tmp_path / "ini")
    assert got == str(tmp_path / "env")
    assert not (tmp_path / "ini").exists()       # no other dir set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_default_applies_without_env_or_path(monkeypatch,
                                             restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compilation_cache() == default_cache_dir()
    assert jax.config.jax_compilation_cache_dir == default_cache_dir()


def test_entries_land_only_in_the_env_dir(tmp_path):
    env_dir, ini_dir = tmp_path / "env", tmp_path / "ini"
    got = _compile_in_child(tmp_path, repr(str(ini_dir)), env_dir=env_dir)
    assert got == str(env_dir)
    assert any(env_dir.iterdir())
    assert not ini_dir.exists()


def test_entries_land_in_the_given_dir_without_env(tmp_path):
    ini_dir = tmp_path / "ini"
    got = _compile_in_child(tmp_path, repr(str(ini_dir)))
    assert got == str(ini_dir)
    assert any(ini_dir.iterdir())
