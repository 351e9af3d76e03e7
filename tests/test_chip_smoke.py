"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions agree with the oracle at tiny sizes.

The timings the phases take here are CPU times and are never reported;
only the comparisons are checked.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from image_lens_reproject_tpu.io import exr, png
from image_lens_reproject_tpu.utils import device

ROOT = Path(cs.__file__).resolve().parent


def _no_smi():
    raise FileNotFoundError("nvidia-smi")


@pytest.mark.parametrize("four_cards", [False, True])
@pytest.mark.parametrize("smi", ["missing", "present"])
def test_main_without_gpu_fails_without_ok(monkeypatch, capsys, smi, four_cards):
    # Without nvidia-smi, or with it but only CPU devices in JAX, the
    # script exits non-zero before any phase and prints no ok line.
    fake = _no_smi if smi == "missing" else (lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(device, "nvidia_smi", fake)
    rc = cs.main(["--four-cards"] if four_cards else [])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("job", cs.jobs(32), ids=lambda j: j.name)
def test_job_at_tiny_size_matches_oracle(job, tmp_path):
    r = cs.run_job(job, tmp_path, reps=1)
    assert r["device_vs_oracle"]["p999"] < cs.DEVICE_TOL
    assert len(r["file_vs_oracle"]) == job.frames
    assert all(f["p999"] <= 1.0 for f in r["file_vs_oracle"])
    if job.frames > 1:
        assert r["skipped"] == job.frames
    w, h = job.out_size
    channels = job.channels
    taps = cs.TAPS["bicubic" if "--bc" in job.flags else "bilinear"]
    assert r["bytes_per_px"] == (taps + 1) * channels * 4
    assert r["memory_analysis"]["output_size_in_bytes"] == w * h * channels * 4


def test_four_cards_phase_on_virtual_devices():
    # Three frames on a batch axis of 4 also exercises the batch padding.
    r = cs.four_cards(frames=3, size=(64, 32), out_size=(48, 24))
    assert r["single_vs_oracle"]["p999"] < cs.DEVICE_TOL
    for mesh in ("4,1", "2,2"):
        assert r[f"mesh_{mesh}_vs_single"]["max"] < 1e-4


def test_abs_error_counts_nonfinite():
    got = np.array([1.0, np.nan, np.inf, np.nan, 2.0], np.float32)
    want = np.array([1.5, np.nan, np.inf, 0.0, np.inf], np.float32)
    np.testing.assert_array_equal(
        cs.abs_error(got, want), [0.5, 0.0, 0.0, np.inf, np.inf])
    stats = cs.compare_arrays(got, want)
    assert stats["n_beyond"] == 3
    assert stats["nonfinite_got"] == 3 and stats["nonfinite_want"] == 3


@pytest.mark.parametrize("ext", [".png", ".exr"])
def test_compare_written_steps(ext, tmp_path):
    img = cs.pattern(16, 24, 3, seed=5, hi=1.0)
    path = tmp_path / ("out" + ext)
    (png.write_png if ext == ".png" else exr.write_exr)(str(path), img)
    same = cs.compare_written(path, img, tmp_path / ("ref" + ext))
    assert same["max"] == 0.0
    off = cs.compare_written(path, img * 0.8, tmp_path / ("ref" + ext))
    assert off["p999"] > 1.0


def test_job_argv_round_trips_through_the_cli_parser(tmp_path):
    from image_lens_reproject_tpu import cli

    job = cs.jobs()[2]
    argv = cs.job_argv(job, [tmp_path / "a.exr"], tmp_path, tmp_path / "out")
    opts, out_cfg = cli.options_from_args(cli.build_parser().parse_args(argv))
    assert out_cfg is None
    assert (opts.out_width, opts.out_height) == (3840, 2160)
    assert opts.interp == "bicubic"
    assert opts.exposure == 2.0 and opts.reinhard == 4.0
