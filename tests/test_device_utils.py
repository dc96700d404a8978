"""The GPU measurement helpers (utils/device.py, utils/cache.py) that
chip_smoke.py and bench.py stand on."""

import json
from pathlib import Path

import pytest

import jax

from gf2bv_tpu.utils import cache, device


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU: JAX runs on cpu"):
        device.require_gpu()
    with pytest.raises(RuntimeError, match="nothing"):
        device.require_gpu([])


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_result_line_format():
    devs = device.require_gpu([_FakeGpu()] * 4)
    line = device.result_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
    }
    assert device.device_record(jax.devices())["platform"] == "cpu"


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = Path(__file__).resolve().parents[1]
    assert cache.cache_dir() == str(root / ".jax_cache")


def test_enable_persistent_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_persistent_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_pins_cuda(monkeypatch):
    """chip_smoke.py sets JAX_PLATFORMS=cuda before JAX is imported, so a
    machine without a GPU fails at start-up instead of running on the CPU."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    pin = src.index('os.environ["JAX_PLATFORMS"] = "cuda"')
    assert pin < src.index("import jax")
    assert "except" not in src
