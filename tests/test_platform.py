"""Per-platform implementation choice (platform.py) and the compile-cache
location (utils/compile_cache.py)."""

import jax
import pytest

from dumphfdl_tpu import platform
from dumphfdl_tpu.utils import compile_cache


@pytest.mark.parametrize('backend,tracker,fused', [
    ('gpu', 'kernel', 64),
    ('cpu', 'scan', 0),
    ('rocm', 'scan', 0),
])
def test_choice_per_backend(backend, tracker, fused):
    choice = platform.choose(backend)
    assert choice.tracker == tracker
    assert choice.fused_event_decode == fused
    # interpret mode is never a platform's choice
    assert choice.tracker != 'interpret'


def test_current_on_cpu(monkeypatch):
    monkeypatch.delenv('DUMPHFDL_TRACKER', raising=False)
    assert platform.current() == platform.choose('cpu')


@pytest.mark.parametrize('override', ['scan', 'kernel'])
def test_tracker_override(monkeypatch, override):
    monkeypatch.setenv('DUMPHFDL_TRACKER', override)
    assert platform.current().tracker == override


def test_tracker_override_rejects_interpret(monkeypatch):
    monkeypatch.setenv('DUMPHFDL_TRACKER', 'interpret')
    with pytest.raises(ValueError):
        platform.current()


def test_bank_takes_platform_choice(monkeypatch):
    from dumphfdl_tpu.dsp.channel import ChannelBank
    monkeypatch.delenv('DUMPHFDL_TRACKER', raising=False)
    bank = ChannelBank(2, auto_shard=False)
    assert bank.tracker == 'scan' and bank.fused_event_decode == 0
    with pytest.raises(ValueError):
        ChannelBank(2, auto_shard=False, tracker='pallas')


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', old)


def test_compile_cache_env_set(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    jax.config.update('jax_compilation_cache_dir', str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # nothing is set in code: the variable's directory stays in force
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_env_unset(monkeypatch, cache_config):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(compile_cache.DEFAULT_DIR)
    assert compile_cache.DEFAULT_DIR.name == '.jax_cache'
    assert (compile_cache.DEFAULT_DIR.parent / 'dumphfdl_tpu').is_dir()
    assert jax.config.jax_compilation_cache_dir == got
