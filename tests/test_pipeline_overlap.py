"""Pipeline stage-overlap evidence (SURVEY §2.3, VERDICT r3 #5).

The 3-stage pipeline (decode threads -> batched device dispatch ->
encode threads) claims host IO overlaps device compute — the analog
of the reference's CTPL per-image fan-out (src/main.cpp:536-660). A
1-core CI host cannot demonstrate that with real codecs (every stage
competes for the same core), so the stages are stubbed with
GIL-releasing sleeps — exactly what file IO and an async accelerator
dispatch look like to the host thread — and the end-to-end wall clock
must come in well under the serialized stage sum. This pins the
ORCHESTRATION (prefetch depth, async handoff, encode futures), which is
host-count independent.
"""

import time
from pathlib import Path

import numpy as np

from image_lens_reproject_tpu import pipeline
from image_lens_reproject_tpu.io.image import DataLayout, ImageBuffer
from image_lens_reproject_tpu.models.lens import Rectilinear

N_FRAMES = 6
DECODE_S = 0.08
DEVICE_S = 0.08
ENCODE_S = 0.08


def _opts(tmp_path):
    lens = Rectilinear(35.0, 36.0, 36.0)
    return pipeline.PipelineOptions(
        input_lens=lens, output_lens=lens, out_width=16, out_height=16,
        interp="bilinear", store_exr=True, num_threads=4, batch_size=1,
    )


def test_stages_overlap(tmp_path, monkeypatch):
    img = np.zeros((16, 16, 3), np.float32)

    def fake_read(path):
        time.sleep(DECODE_S)
        return ImageBuffer(img.copy(), DataLayout.RGB)

    def fake_process(images, opts):
        time.sleep(DEVICE_S)  # async device dispatch + fetch stand-in
        return [i.copy() for i in images]

    def fake_write(out, layout, opts, out_png, out_exr):
        time.sleep(ENCODE_S)

    monkeypatch.setattr(pipeline, "read_image", fake_read)
    monkeypatch.setattr(pipeline, "process_batch", fake_process)
    monkeypatch.setattr(pipeline, "write_outputs", fake_write)

    paths = [Path(f"/nonexistent/frame{i:03d}.exr") for i in range(N_FRAMES)]
    stats = pipeline.run_pipeline(paths, str(tmp_path / "out"), _opts(tmp_path))

    assert stats.done == N_FRAMES and not stats.failed
    serialized = N_FRAMES * (DECODE_S + DEVICE_S + ENCODE_S)
    # Ideal pipelined floor is ~N*DEVICE_S (+ one decode/encode tail).
    # Require at least ~35% saved over fully-serialized: decode/encode
    # demonstrably ran concurrent with the device stage.
    assert stats.wall_seconds < 0.65 * serialized, (
        f"pipeline did not overlap: wall={stats.wall_seconds:.2f}s "
        f"vs serialized {serialized:.2f}s"
    )


def test_failures_do_not_stall_overlap(tmp_path, monkeypatch):
    """A decode failure mid-stream is isolated and the rest still pipeline."""
    img = np.zeros((16, 16, 3), np.float32)

    def fake_read(path):
        time.sleep(DECODE_S)
        if "frame002" in path.name:
            raise IOError("corrupt frame")
        return ImageBuffer(img.copy(), DataLayout.RGB)

    monkeypatch.setattr(pipeline, "read_image", fake_read)
    monkeypatch.setattr(
        pipeline, "process_batch",
        lambda images, opts: (time.sleep(DEVICE_S), [i.copy() for i in images])[1],
    )
    monkeypatch.setattr(
        pipeline, "write_outputs", lambda *a, **k: time.sleep(ENCODE_S)
    )

    paths = [Path(f"/nonexistent/frame{i:03d}.exr") for i in range(N_FRAMES)]
    stats = pipeline.run_pipeline(paths, str(tmp_path / "out"), _opts(tmp_path))
    assert stats.done == N_FRAMES - 1
    assert stats.failed == ["frame002.exr"]
    serialized = N_FRAMES * (DECODE_S + DEVICE_S + ENCODE_S)
    assert stats.wall_seconds < 0.65 * serialized


def test_serial_ordering(tmp_path, monkeypatch):
    """ordering='serial' completes each frame before the next decode
    starts (for serialized device links where overlap measured slower,
    r4b battery) and the choice is recorded on the stats."""
    img = np.zeros((16, 16, 3), np.float32)
    events = []

    def fake_read(path):
        events.append(("decode", path.name))
        return ImageBuffer(img.copy(), DataLayout.RGB)

    def fake_process(images, opts):
        return [i.copy() for i in images]

    def fake_write(out, layout, opts, out_png, out_exr):
        events.append(("write", out_png.stem))

    monkeypatch.setattr(pipeline, "read_image", fake_read)
    monkeypatch.setattr(pipeline, "process_batch", fake_process)
    monkeypatch.setattr(pipeline, "write_outputs", fake_write)

    opts = _opts(tmp_path)
    opts.ordering = "serial"
    paths = [Path(f"/nonexistent/frame{i:03d}.exr") for i in range(4)]
    stats = pipeline.run_pipeline(paths, str(tmp_path / "out"), opts)
    assert stats.done == 4 and not stats.failed
    assert stats.ordering == "serial"
    # strict alternation: decode_i, write_i, decode_{i+1}, ...
    assert events == [
        ev for i in range(4)
        for ev in (("decode", f"frame{i:03d}.exr"), ("write", f"frame{i:03d}"))
    ]


def test_bad_ordering_rejected(tmp_path):
    opts = _opts(tmp_path)
    opts.ordering = "speedy"
    try:
        pipeline.run_pipeline([], str(tmp_path / "out"), opts)
    except ValueError as e:
        assert "ordering" in str(e)
    else:
        raise AssertionError("invalid ordering must raise")
