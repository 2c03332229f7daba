"""Where the persistent compilation cache lives, and that tests write
none."""

import os

import jax

from remixt_jax import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _enable(monkeypatch, config=None):
    """enable_compilation_cache from a fresh state, recording the jax
    config updates it makes instead of applying them."""
    updates = {}
    monkeypatch.setattr(compile_cache, '_enabled_dir', None)
    monkeypatch.setattr(jax.config, 'update',
                        lambda name, value: updates.__setitem__(name, value))
    return compile_cache.enable_compilation_cache(config), updates


def test_cache_uses_jax_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    active, updates = _enable(monkeypatch)
    assert active == str(tmp_path)
    # JAX reads its own variable; the program sets no other directory
    assert 'jax_compilation_cache_dir' not in updates


def test_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    expected = os.path.join(REPO, '.jax_cache')
    assert compile_cache.cache_dir() == expected
    active, updates = _enable(monkeypatch)
    assert active == expected
    assert updates == {'jax_compilation_cache_dir': expected}


def test_config_turns_the_cache_off(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    active, updates = _enable(monkeypatch, {'use_compilation_cache': False})
    assert active is None and updates == {}


def test_tests_write_no_persistent_cache():
    assert jax.config.jax_enable_compilation_cache is False
    # subprocesses the tests start inherit the switch
    assert os.environ['JAX_ENABLE_COMPILATION_CACHE'] == 'false'
