"""Compile-cache policy (utils/cache.py): the environment's directory
when JAX_COMPILATION_CACHE_DIR is set, else one fixed git-ignored
directory inside the checkout."""

import os

import jax
import pytest

from flowonthego.utils import cache


@pytest.fixture()
def config_calls(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_dir_is_used_and_nothing_else_is_named(monkeypatch, tmp_path,
                                                    config_calls):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_calls


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch,
                                                  config_calls):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = cache.enable_compile_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert config_calls["jax_compilation_cache_dir"] == path
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
