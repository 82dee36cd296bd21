"""Where the persistent compilation cache goes, and on which backend."""

import jax
import pytest

from spades_for_blackbird_tpu.utils import jaxcache


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of changing the process's
    configuration."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_cache_uses_env_directory_on_gpu(monkeypatch, tmp_path, updates):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert jaxcache.enable_compilation_cache() == str(tmp_path / "c")
    assert updates["jax_compilation_cache_dir"] == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


def test_cache_defaults_to_fixed_checkout_path(monkeypatch, updates):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcache.enable_compilation_cache()
    assert path == jaxcache._DEFAULT
    assert path.endswith(".jax_cache")
    assert updates["jax_compilation_cache_dir"] == path
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_cache_stays_off_on_cpu(monkeypatch, updates):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert jaxcache.enable_compilation_cache() == ""
    assert updates == {}
