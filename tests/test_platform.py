"""The platform decision (utils/device.py) and the compile-cache rule
(utils/cache.py)."""

import types

import jax

from ldpc_erasure_codes_tpu.utils import cache, device


def test_on_gpu_false_on_cpu():
    assert jax.default_backend() == "cpu"
    assert device.on_gpu() is False


class _FakeConfig:
    def __init__(self, platforms):
        self.values = {"jax_platforms": platforms}
        self.updates = {}

    def update(self, name, value):
        self.updates[name] = value


def _fake_jax(monkeypatch, platforms):
    cfg = _FakeConfig(platforms)
    monkeypatch.setattr(cache, "jax", types.SimpleNamespace(config=cfg))
    return cfg


def test_cache_env_dir_is_used_and_nothing_is_set(monkeypatch, tmp_path):
    cfg = _fake_jax(monkeypatch, "")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert cfg.updates == {}


def test_cache_env_dir_wins_on_cpu_too(monkeypatch, tmp_path):
    cfg = _fake_jax(monkeypatch, "cpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert cfg.updates == {}


def test_cache_off_on_cpu_backend(monkeypatch):
    cfg = _fake_jax(monkeypatch, "cpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.enable_persistent_cache() is None
    assert cfg.updates == {}


def test_cache_default_is_fixed_repo_dir(monkeypatch, tmp_path):
    cfg = _fake_jax(monkeypatch, "")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    target = tmp_path / ".jax_cache"
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(target))
    assert cache.enable_persistent_cache() == str(target)
    assert target.is_dir()
    assert cfg.updates == {"jax_compilation_cache_dir": str(target)}
    # Stable across calls: the path is part of the cache key.
    assert cache.enable_persistent_cache() == str(target)


def test_default_cache_dir_is_repo_local():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
