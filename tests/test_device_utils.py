"""utils/device.py: where the persistent compile cache goes, and the
card query that stays off JAX."""

from pathlib import Path

import jax

from dsd2dxd_tpu.utils import device

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("DSD2DXD_COMPILE_CACHE", raising=False)
    got = device.enable_compile_cache()
    assert got == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(got)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_leaves_jax_env_alone(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    program configures no other directory."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() is None
    assert device.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_off(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    for off in ("off", "0", "OFF"):
        monkeypatch.setenv("DSD2DXD_COMPILE_CACHE", off)
        assert device.compile_cache_dir() is None
    assert device.compile_cache_dir({}) == REPO / ".jax_cache"


def test_card_info_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert device.card_info() == "not available"
