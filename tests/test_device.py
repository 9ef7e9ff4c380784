"""Where the program runs: the compile-cache directory and the CLI's refusal
to fall back to the CPU when the GPU is asked for."""
import os
import subprocess
import sys

import jax
import pytest

from jet_pbrt_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cache_config():
    """Restore JAX's cache setting after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_from_environment(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other cache is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_checkout(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_refuses_missing_gpu(tmp_path):
    """--platform gpu without a GPU exits non-zero and renders nothing."""
    out = tmp_path / "img"
    r = subprocess.run(
        [sys.executable, "-m", "jet_pbrt_tpu.cli", "0", "1", "--size", "4",
         "--platform", "gpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stderr
    assert "no gpu device" in r.stderr
    assert not list(tmp_path.iterdir())
