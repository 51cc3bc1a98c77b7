"""Compile-cache location rule: JAX_COMPILATION_CACHE_DIR when set, else
one fixed directory inside the checkout."""
import os

import pytest

from mlimgsynth_tpu.utils import compcache


def test_default_dir_is_in_checkout_and_gitignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compcache.DEFAULT_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("host_subdir", [False, True])
def test_env_var_wins(monkeypatch, tmp_path, host_subdir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compcache.cache_dir(host_subdir) == str(tmp_path)


def test_default_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == compcache.DEFAULT_DIR
    sub = compcache.cache_dir(host_subdir=True)
    assert os.path.dirname(sub) == compcache.DEFAULT_DIR
    assert os.path.basename(sub).startswith("cpu-")


def test_enable_with_env_sets_no_path(monkeypatch, tmp_path):
    """With the variable set, enable() leaves the path to JAX: no other
    directory is configured or created."""
    import jax
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    compcache.enable()
    assert [k for k, _ in calls] == [
        "jax_persistent_cache_min_compile_time_secs"]


def test_enable_without_env_uses_fixed_path(monkeypatch, tmp_path):
    import jax
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compcache, "DEFAULT_DIR", str(tmp_path / "fixed"))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    compcache.enable()
    assert ("jax_compilation_cache_dir", str(tmp_path / "fixed")) in calls
    assert os.path.isdir(tmp_path / "fixed")
