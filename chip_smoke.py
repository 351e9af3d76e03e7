"""Bring-up check: the reprojector's main path on the GPU, at real sizes.

    python chip_smoke.py                # one GPU: the five BASELINE.json jobs
    python chip_smoke.py --four-cards   # four GPUs: the --mesh path only

Everything runs in this one process, because one JAX process holds a card.
Inputs are generated from a fixed seed; nothing is downloaded.

Per job, through the CLI entry point (``cli.main``) at the job's real
sizes:

* time ``remap_fused.remap_tonemap`` on the decoded input: compile
  seconds, steady milliseconds per call (each ended by
  ``block_until_ready``), the compiled program's memory analysis, the
  device's peak bytes in use, bytes per output pixel (source taps read
  plus output written, from shapes) and the GB/s that makes;
* compare that float32 device array with the NumPy oracle
  (``utils/oracle.py``) on the same decoded input: p99.9 absolute error
  below 1e-3;
* run the CLI and compare the file it wrote with the oracle's output sent
  through the same writer and read back: at most one quantisation step at
  p99.9 (one 8-bit code after gamma for PNG, one half-float ulp for EXR).

The remap has no matrix product (the rotation is elementwise), so TF32
does not apply and the tolerances need no precision setting.

``--four-cards`` runs ``pipeline.process_batch`` on a batch of eight 4K
RGBZ frames with ``mesh="4,1"`` and ``mesh="2,2"`` and compares each with
the single-card result of the same batch.

Any failure, or a platform other than ``gpu``, exits non-zero and prints
no ``ok`` line. On success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from image_lens_reproject_tpu import cli, pipeline  # noqa: E402
from image_lens_reproject_tpu.io import exr as exr_io  # noqa: E402
from image_lens_reproject_tpu.io import png as png_io  # noqa: E402
from image_lens_reproject_tpu.utils import (  # noqa: E402
    compile_cache, device, native, oracle, tracing,
)

PI = "3.14159265358979"
DEVICE_TOL = 1e-3  # p99.9 absolute error of the device array vs the oracle
REPS = 5
TAPS = {"nearest": 1, "bilinear": 4, "bicubic": 16}


@dataclasses.dataclass(frozen=True)
class Job:
    """One BASELINE.json job: generated inputs and the CLI flags that run it."""

    name: str
    in_size: tuple  # (width, height)
    out_size: tuple  # (width, height)
    channels: int  # 3 = RGB, 4 = RGBZ
    in_ext: str
    out_ext: str
    flags: tuple  # lens, sampling and output flags
    frames: int = 1  # > 1: a directory run (-i), then again with --skip-if-exists
    camera: Optional[dict] = None  # Blender camera block: run through --input-cfg


def jobs(div: int = 1) -> list:
    """The five BASELINE.json jobs; ``div`` shrinks every size (tests)."""

    def size(w, h):
        return (max(8, w // div), max(8, h // div))

    return [
        Job("1_fisheye_rect_png", size(1080, 1080), size(1920, 1080), 3,
            ".png", ".png",
            ("--i-equidistant", PI, "--rectilinear", "35,36", "--bl", "--png")),
        Job("2_equisolid_equirect_rot", size(2048, 2048), size(4096, 2048), 3,
            ".exr", ".exr",
            ("--i-equisolid", f"15,36,{PI}", "--equirectangular", "full",
             "--rotation", "30,10,5", "--bl", "--exr")),
        Job("3_equirect_rect_tonemap", size(3840, 1920), size(3840, 2160), 3,
            ".exr", ".png",
            ("--i-equirectangular", "full", "--rectilinear", "35,36", "--bc",
             "--exposure", "1", "--reinhard", "4", "--png")),
        Job("4_blender_rect_equisolid_rgbz", size(2048, 2048), size(2048, 2048), 4,
            ".exr", ".exr",
            ("--equisolid", f"15,36,{PI}", "--bl", "--exr"),
            camera={"type": "PERSP", "lens_unit": "MILLIMETERS",
                    "focal_length": 50.0}),
        Job("5_exr_directory_rgbz", size(3840, 1920), size(3840, 2160), 4,
            ".exr", ".exr",
            ("--i-equirectangular", "full", "--rectilinear", "35,36", "--bc",
             "-j", "8", "--exr"),
            frames=6),
    ]


def pattern(h: int, w: int, channels: int, seed: int, hi: float = 2.0) -> np.ndarray:
    """Smooth float32 test image with a few cycles of detail per channel;
    an RGBZ image carries depth in 1..21 in its last channel."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    out = np.empty((h, w, channels), np.float32)
    for c in range(channels):
        a, b, p = rng.uniform(1.0, 3.0, 3).astype(np.float32)
        wave = 0.5 + 0.5 * np.sin(a * 8 * xx + b * 6 * yy + p) * np.cos(b * 5 * xx - a * 4 * yy)
        lo, top = (1.0, 21.0) if (channels == 4 and c == 3) else (0.02, hi)
        out[..., c] = lo + (top - lo) * wave
    return out


def write_inputs(job: Job, in_dir: Path, seed: int) -> list:
    """Generate the job's input files (and Blender config); returns them."""
    in_dir.mkdir(parents=True, exist_ok=True)
    w, h = job.in_size
    paths = []
    for i in range(job.frames):
        p = in_dir / f"frame{i:04d}{job.in_ext}"
        if job.in_ext == ".png":
            png_io.write_png(str(p), pattern(h, w, job.channels, seed + i, hi=1.0))
        else:
            names = ["R", "G", "B", "Z"] if job.channels == 4 else None
            exr_io.write_exr(str(p), pattern(h, w, job.channels, seed + i),
                             channel_names=names)
        paths.append(p)
    if job.camera is not None:
        cfg = {"camera": job.camera, "sensor_size": [36.0, 36.0],
               "resolution": [w, h], "frames": [{"name": p.name} for p in paths]}
        (in_dir / "camera.json").write_text(json.dumps(cfg, indent=2))
    return paths


def job_argv(job: Job, paths: Sequence[Path], in_dir: Path, out_dir: Path) -> list:
    """The CLI arguments a user would type for this job."""
    argv = ["-o", str(out_dir)]
    if job.camera is not None:
        check(job.out_size == job.in_size, "a config job keeps the input size")
        argv += ["--input-cfg", str(in_dir / "camera.json"),
                 "--output-cfg", str(out_dir / "camera.json")]
    else:
        argv += ["--no-configs", "%d,%d" % job.in_size,
                 "--output-resolution", "%d,%d" % job.out_size]
    if job.frames > 1:
        argv += ["-i", str(in_dir)]
    else:
        argv += ["--single", str(paths[0])]
    return argv + list(job.flags)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def remap_kwargs(opts) -> dict:
    return dict(
        in_lens=opts.input_lens, out_lens=opts.output_lens,
        out_h=opts.out_height, out_w=opts.out_width, interp=opts.interp,
        n_samples=opts.n_samples, exposure=opts.exposure, reinhard=opts.reinhard,
    )


def oracle_output(src: np.ndarray, rotation, kw: dict) -> np.ndarray:
    """The float32 NumPy oracle with the same settings as the device call."""
    out = oracle.oracle_remap(
        src, rotation, in_lens=kw["in_lens"], out_lens=kw["out_lens"],
        out_h=kw["out_h"], out_w=kw["out_w"], interp=kw["interp"],
        n_samples=kw["n_samples"],
    )
    if kw["exposure"] != 1.0 or kw["reinhard"] != 1.0:
        out = oracle.oracle_post_process(out, kw["exposure"], kw["reinhard"])
    return out


def error_stats(err: np.ndarray, tol: float) -> dict:
    """p99.9 and max of an error array, and how many elements exceed tol."""
    err = np.asarray(err, np.float64).ravel()
    with np.errstate(invalid="ignore"):  # quantiles between infs
        p999 = float(np.quantile(err, 0.999))
    return {
        "p999": p999,
        "max": float(err.max()),
        "n_beyond": int(np.count_nonzero(err > tol)),
        "n": int(err.size),
    }


def abs_error(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want|, with equal values (infs, NaN against NaN) as 0 and a
    NaN against a number as inf, so non-finite outliers are counted."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        err = np.abs(got - want)
    err[(got == want) | (np.isnan(got) & np.isnan(want))] = 0.0
    return np.where(np.isnan(err), np.inf, err)


def compare_arrays(got: np.ndarray, want: np.ndarray, tol: float = DEVICE_TOL) -> dict:
    check(got.shape == want.shape, f"shapes differ: {got.shape} vs {want.shape}")
    stats = error_stats(abs_error(got, want), tol)
    stats["nonfinite_got"] = int(np.count_nonzero(~np.isfinite(got)))
    stats["nonfinite_want"] = int(np.count_nonzero(~np.isfinite(want)))
    return stats


def compare_written(path: Path, want: np.ndarray, scratch: Path) -> dict:
    """The written file against the oracle sent through the same writer and
    read back; errors in quantisation steps (8-bit codes for PNG, half-float
    ulps for EXR)."""
    if path.suffix == ".png":
        png_io.write_png(str(scratch), want)
        got = png_io.decode_rgba8(str(path))[..., :3].astype(np.int32)
        ref = png_io.decode_rgba8(str(scratch))[..., :3].astype(np.int32)
        err = np.abs(got - ref)
    else:
        exr_io.write_exr(str(scratch), want)
        got = exr_io.read_exr(str(path)).data
        ref = exr_io.read_exr(str(scratch)).data
        check(got.shape == ref.shape, f"{path.name}: shape {got.shape} vs {ref.shape}")
        ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float64)
        err = abs_error(got, ref) / ulp
    scratch.unlink()
    return error_stats(err, 1.0)


def time_remap(src: np.ndarray, rotation, kw: dict, reps: int):
    """Compile and time remap_tonemap on the first device; (output, readings)."""
    import jax

    from image_lens_reproject_tpu.ops import remap_fused

    dev = jax.devices()[0]
    x = jax.device_put(src, dev)
    rot = None if rotation is None else jax.device_put(np.asarray(rotation, np.float32), dev)
    t0 = time.perf_counter()
    compiled = remap_fused.remap_tonemap.lower(x, rot, **kw).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(x, rot).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        compiled(x, rot).block_until_ready()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    channels = int(src.shape[2])
    bytes_per_px = (TAPS[kw["interp"]] * kw["n_samples"] ** 2 + 1) * channels * 4
    readings = {
        "platform": dev.platform,
        "compile_s": compile_s,
        "remap_ms": ms,
        "remap_ms_reps": [t * 1e3 for t in times],
        "bytes_per_px": bytes_per_px,
        "gb_per_s": bytes_per_px * kw["out_h"] * kw["out_w"] / (ms / 1e3) / 1e9,
    }
    mem = compiled.memory_analysis()
    if mem is not None:
        readings["memory_analysis"] = {
            k: int(getattr(mem, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes",
                "peak_memory_in_bytes")
        }
    stats = dev.memory_stats()
    if stats:
        readings["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])
    return np.asarray(out), readings


def run_cli(argv: Sequence[str]):
    """cli.main in this process; (exit code, captured stdout)."""
    tracing.reset_zones()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, buf.getvalue()


def run_job(job: Job, work: Path, reps: int = REPS, seed: int = 0,
            peak_bytes_per_s: Optional[float] = None) -> dict:
    """One job end to end; prints its readings, raises on any failure."""
    readings = {"job": job.name}
    try:
        in_dir, out_dir = work / "in", work / "out"
        t0 = time.perf_counter()
        paths = write_inputs(job, in_dir, seed)
        readings["inputs_s"] = time.perf_counter() - t0
        argv = job_argv(job, paths, in_dir, out_dir)
        opts, _ = cli.options_from_args(cli.build_parser().parse_args(argv))
        kw = remap_kwargs(opts)

        src = pipeline.read_image(paths[0]).data
        got, timing = time_remap(src, opts.rotation, kw, reps)
        readings.update(timing)
        if peak_bytes_per_s:
            readings["hbm_share"] = timing["gb_per_s"] * 1e9 / peak_bytes_per_s
        t0 = time.perf_counter()
        want = oracle_output(src, opts.rotation, kw)
        readings["oracle_s"] = time.perf_counter() - t0
        readings["device_vs_oracle"] = compare_arrays(got, want)
        check(readings["device_vs_oracle"]["p999"] < DEVICE_TOL,
              f"{job.name}: device array differs from the oracle")

        t0 = time.perf_counter()
        rc, log = run_cli(argv)
        readings["cli_s"] = time.perf_counter() - t0
        readings["cli_log"] = [
            line.strip() for line in log.splitlines()
            if line.startswith(("Throughput", "Error", "Failed")) or "ms total" in line]
        check(rc == 0, f"{job.name}: cli exited {rc}:\n{log}")
        files = []
        for i, p in enumerate(paths):
            out = out_dir / (p.stem + job.out_ext)
            check(out.exists(), f"{job.name}: no output {out.name}:\n{log}")
            ref = want if i == 0 else oracle_output(
                pipeline.read_image(p).data, opts.rotation, kw)
            files.append(compare_written(out, ref, work / ("ref" + job.out_ext)))
        readings["file_vs_oracle"] = files
        for f in files:
            check(f["p999"] <= 1.0,
                  f"{job.name}: written file differs from the oracle by more "
                  "than one quantisation step")

        if job.frames > 1:
            outs = [out_dir / (p.stem + job.out_ext) for p in paths]
            before = [o.stat().st_mtime_ns for o in outs]
            rc, log = run_cli(argv + ["--skip-if-exists"])
            skipped = sum(line.startswith("Skipping") for line in log.splitlines())
            readings["skipped"] = skipped
            check(rc == 0 and skipped == job.frames,
                  f"{job.name}: --skip-if-exists skipped {skipped} of {job.frames}")
            check([o.stat().st_mtime_ns for o in outs] == before,
                  f"{job.name}: --skip-if-exists rewrote outputs")
    finally:
        print("job " + json.dumps(readings), flush=True)
    return readings


def four_cards(frames: int = 8, size=(3840, 1920), out_size=(3840, 2160),
               seed: int = 0) -> dict:
    """process_batch over a (4,1) and a (2,2) mesh vs the single card."""
    import jax

    check(len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}")
    job = dataclasses.replace(jobs()[4], in_size=size, out_size=out_size)
    argv = job_argv(job, [], Path("in"), Path("out"))
    opts, _ = cli.options_from_args(cli.build_parser().parse_args(argv))
    w, h = size
    batch = [pattern(h, w, 4, seed + i) for i in range(frames)]

    readings = {"frames": frames, "size": list(size), "out_size": list(out_size)}
    try:
        pipeline.process_batch(batch, opts)  # compile
        t0 = time.perf_counter()
        single = np.stack(pipeline.process_batch(batch, opts))
        readings["single_s"] = time.perf_counter() - t0
        readings["single_vs_oracle"] = compare_arrays(
            single[0], oracle_output(batch[0], opts.rotation, remap_kwargs(opts)))
        check(readings["single_vs_oracle"]["p999"] < DEVICE_TOL,
              "single-card batch differs from the oracle")
        for mesh in ("4,1", "2,2"):
            m_opts = dataclasses.replace(opts, mesh=mesh)
            shape = tuple(int(v) for v in mesh.split(","))
            check(pipeline._resolve_mesh(m_opts) == shape, f"mesh {mesh} not used")
            pipeline.process_batch(batch, m_opts)  # compile
            t0 = time.perf_counter()
            got = np.stack(pipeline.process_batch(batch, m_opts))
            readings[f"mesh_{mesh}_s"] = time.perf_counter() - t0
            readings[f"mesh_{mesh}_vs_single"] = compare_arrays(got, single)
            check(readings[f"mesh_{mesh}_vs_single"]["p999"] < DEVICE_TOL,
                  f"mesh {mesh} differs from the single-card result")
    finally:
        print("four_cards " + json.dumps(readings), flush=True)
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --mesh path on four GPUs against one")
    args = ap.parse_args(argv)

    try:
        gpu = device.nvidia_smi()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: nvidia-smi failed: {e}", file=sys.stderr)
        return 2
    print(f"nvidia-smi: {gpu}", flush=True)

    import jax

    try:
        devices = device.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    desc = device.describe(devices)
    print(f"jax {jax.__version__}: {desc['count']} x {desc['kind']} ({desc['platform']})")
    print(f"compile cache: {compile_cache.enable()}")
    print("EXR codec: " + ("native" if native.available() else "numpy fallback"))
    print(f"PNG codec: {png_io.BACKEND}", flush=True)

    work = ROOT / ".chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        if args.four_cards:
            four_cards()
        else:
            peak = device.peak_hbm_bytes_per_s(desc["kind"])
            for job in jobs():
                run_job(job, work / job.name, peak_bytes_per_s=peak)
                shutil.rmtree(work / job.name)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": desc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
