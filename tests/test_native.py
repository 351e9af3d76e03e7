"""Native C++ codec core tests: parity with the numpy EXR path."""

import numpy as np
import pytest

from image_lens_reproject_tpu.io import exr
from image_lens_reproject_tpu.utils import native

F = np.float32

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no toolchain)"
)


def hdr_image(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 4, size=(h, w, c)) ** 2).astype(F)


@pytest.mark.parametrize("c", [3, 4, 5])
@pytest.mark.parametrize("compression", ["zips", "zip"])
def test_native_roundtrip(tmp_path, c, compression, monkeypatch):
    img = hdr_image(37, 53, c, seed=c)
    path = str(tmp_path / "t.exr")
    exr.write_exr(path, img, compression=compression)  # native encode path
    back = exr.read_exr(path)  # native decode path
    np.testing.assert_array_equal(back.data, img.astype(np.float16).astype(F))


def test_native_decode_matches_numpy(tmp_path, monkeypatch):
    img = hdr_image(64, 48, 4, seed=9)
    path = str(tmp_path / "t.exr")
    exr.write_exr(path, img)

    native_buf = exr.read_exr(path)
    assert native_buf is not None

    # Force the numpy path and compare byte-for-byte.
    monkeypatch.setenv("ILR_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    numpy_buf = exr.read_exr(path)
    np.testing.assert_array_equal(native_buf.data, numpy_buf.data)
    assert native_buf.layout == numpy_buf.layout


def test_native_encode_matches_numpy_bytes(tmp_path, monkeypatch):
    """Both encoders produce files the reader maps to identical pixels."""
    img = hdr_image(33, 40, 3, seed=11)
    p_native = str(tmp_path / "n.exr")
    exr.write_exr(p_native, img)

    monkeypatch.setenv("ILR_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    p_numpy = str(tmp_path / "p.exr")
    exr.write_exr(p_numpy, img)

    a = exr.read_exr(p_native).data
    b = exr.read_exr(p_numpy).data
    np.testing.assert_array_equal(a, b)


def test_half_conversion_edge_values(tmp_path):
    # Denormals, large values, zero, negatives through the native half path.
    vals = np.array(
        [[0.0, -0.0, 1e-8], [65504.0, -65504.0, 3.14159], [1e-5, -2.5e-6, 0.1]],
        dtype=F,
    ).reshape(3, 1, 3)
    img = np.repeat(np.repeat(vals, 8, axis=0), 8, axis=1)
    path = str(tmp_path / "edge.exr")
    exr.write_exr(path, img)
    back = exr.read_exr(path)
    np.testing.assert_array_equal(back.data, img.astype(np.float16).astype(F))


def test_build_falls_back_to_gxx_when_cmake_fails(tmp_path):
    # A cmake that is on PATH but cannot build (e.g. its ninja is missing)
    # must not stop the build: build.sh compiles with g++ directly.
    import os
    import shutil
    import subprocess
    from pathlib import Path

    src = Path(native._NATIVE_DIR)
    work = tmp_path / "native"
    work.mkdir()
    for name in ("build.sh", "exr_codec.cpp", "CMakeLists.txt"):
        shutil.copy(src / name, work / name)
    fake = tmp_path / "bin"
    fake.mkdir()
    for tool in ("cmake", "ninja"):
        (fake / tool).write_text("#!/bin/sh\nexit 1\n")
        (fake / tool).chmod(0o755)
    env = dict(os.environ, PATH=f"{fake}{os.pathsep}{os.environ['PATH']}")
    proc = subprocess.run(["sh", str(work / "build.sh")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (work / "libilr_native.so").exists()
