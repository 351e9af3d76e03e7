"""The compile-cache location, the device record, and bench.py's refusal
to run without a GPU."""

import importlib.util
from pathlib import Path

import jax
import pytest

from image_lens_reproject_tpu.utils import compile_cache, device

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_unset_goes_to_repo_root(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    want = str(ROOT / ".jax_cache")
    assert compile_cache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want
    # Same path every time: nothing per process or per call in it.
    assert compile_cache.enable() == want


@pytest.mark.parametrize("value", ["/some/cache", ""])
def test_cache_dir_set_is_left_to_jax(monkeypatch, restore_cache_dir, value):
    monkeypatch.setenv(compile_cache.ENV_VAR, value)
    jax.config.update("jax_compilation_cache_dir", "as-jax-read-it")
    assert compile_cache.enable() == "as-jax-read-it"


def test_describe_and_require_gpu_on_cpu():
    devices = jax.devices()
    assert device.describe(devices) == {
        "platform": "cpu", "kind": devices[0].device_kind, "count": len(devices)}
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_peak_table_known_and_unknown_kinds():
    assert device.peak_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no peak bandwidth"):
        device.peak_hbm_bytes_per_s("cpu")


def test_bench_refuses_cpu(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("bench_script", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(device, "nvidia_smi", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    assert capsys.readouterr().out == ""
