"""End-to-end CLI tests: flags -> outputs/config JSON (src/main.cpp parity)."""

import json
import math
import os

import numpy as np
import pytest

from image_lens_reproject_tpu import cli
from image_lens_reproject_tpu.io import exr, png
from image_lens_reproject_tpu.utils import oracle
from image_lens_reproject_tpu.models.lens import FisheyeEquidistant, Rectilinear

F = np.float32


def make_fisheye_png(path, size=64):
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cx, cy = (xx + 0.5) - size / 2, (yy + 0.5) - size / 2
    r = np.sqrt(cx**2 + cy**2) / (size / 2)
    img = np.stack(
        [0.5 + 0.4 * np.sin(r * 6), 0.5 + 0.4 * np.cos(cx * 0.2), np.clip(1 - r, 0, 1)],
        axis=-1,
    ).astype(F)
    png.write_png(str(path), img)
    return img


class TestArgValidation:
    def test_no_input(self, capsys):
        assert cli.main(["-o", "/tmp/x", "--png"]) == 1
        assert "No input specified" in capsys.readouterr().out

    def test_both_inputs(self, capsys, tmp_path):
        rc = cli.main(["-i", str(tmp_path), "--single", "a.png", "-o", "/tmp/x", "--png"])
        assert rc == 1
        assert "cannot specify both" in capsys.readouterr().out

    def test_no_format(self, capsys, tmp_path):
        rc = cli.main(["--single", "a.png", "-o", "/tmp/x"])
        assert rc == 1
        assert "Did not specify any output format" in capsys.readouterr().out

    def test_two_interps_prints_help_but_continues(self, capsys, tmp_path):
        # The reference prints the error + help and CONTINUES with the last
        # interpolation flag it processed (src/main.cpp:373-376 has no exit).
        make_fisheye_png(tmp_path / "in.png", size=16)
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--single", str(tmp_path / "in.png"), "-o", str(out_dir), "--png",
            "--no-configs", "16,16", "--i-equidistant", "180",
            "--rectilinear", "35,36", "--nn", "--bl",
        ])
        assert rc == 0  # continues despite the conflict
        assert "more than one interpolation" in capsys.readouterr().out
        got = png.read_png(str(out_dir / "in.png")).data

        # nn + bl resolves to bilinear (the later assignment wins).
        src = png.read_png(str(tmp_path / "in.png")).data
        want = oracle.oracle_remap(
            src, None,
            in_lens=FisheyeEquidistant(fov=180.0, sensor_width=36.0, sensor_height=36.0),
            out_lens=Rectilinear(35.0, 36.0, 36.0),
            out_h=16, out_w=16, interp="bilinear", n_samples=1,
        )
        png.write_png(str(tmp_path / "oracle.png"), want)
        want_rt = png.read_png(str(tmp_path / "oracle.png")).data
        np.testing.assert_allclose(got, want_rt, atol=1e-6)

    def test_two_input_lenses(self, capsys, tmp_path):
        rc = cli.main([
            "--single", "a.png", "-o", "/tmp/x", "--png",
            "--no-configs", "64,64",
            "--i-equidistant", "180", "--i-rectilinear", "35,36",
            "--rectilinear", "35,36",
        ])
        assert rc == 1
        assert "only specify one input lens type" in capsys.readouterr().out

    def test_two_output_lenses(self, capsys, tmp_path):
        rc = cli.main([
            "--single", "a.png", "-o", "/tmp/x", "--png",
            "--no-configs", "64,64",
            "--i-equidistant", "180",
            "--rectilinear", "35,36", "--equidistant", "180",
        ])
        assert rc == 1
        assert "only specify one output lens type" in capsys.readouterr().out


class TestRuntimeOptions:
    @pytest.mark.parametrize("flag", ["--pure-xla", "--rescue=on", "--split=on"])
    def test_kernel_selection_flags_are_gone(self, flag, capsys):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["--single", "a.png", "-o", "out", flag])
        assert "unrecognized arguments" in capsys.readouterr().err

    def test_options_from_args_writes_nothing(self, tmp_path):
        argv = ["--single", "a.png", "-o", str(tmp_path / "out"), "--png",
                "--no-configs", "64,64", "--i-equidistant", "3.14159265358979",
                "--rectilinear", "35,36", "--output-resolution", "32,16",
                "--bl", "--rotation", "10,0,0", "--mesh", "2,1"]
        opts, out_cfg = cli.options_from_args(cli.build_parser().parse_args(argv))
        assert out_cfg is None
        assert (opts.out_width, opts.out_height, opts.interp) == (32, 16, "bilinear")
        assert opts.rotation.shape == (3, 3) and opts.mesh == "2,1"
        assert not (tmp_path / "out").exists()


class TestLensStringParsers:
    def test_rectilinear_derives_sensor_height(self):
        lens = cli.parse_rectilinear("35,36", 1920, 1080)
        assert lens.focal_length == 35.0 and lens.sensor_width == 36.0
        assert lens.sensor_height == pytest.approx(1080 / 1920 * 36.0)

    def test_equidistant_hardcoded_sensor(self):
        lens = cli.parse_equidistant("180", 1920, 1080)
        assert lens.sensor_width == 36.0 and lens.sensor_height == 36.0
        assert lens.fov == 180.0

    def test_equisolid(self):
        lens = cli.parse_equisolid("15,36,180", 1000, 500)
        assert lens.focal_length == 15.0 and lens.sensor_width == 36.0
        assert lens.fov == 180.0 and lens.sensor_height == 18.0

    def test_equirect_full(self):
        lens = cli.parse_equirectangular("full", 100, 50)
        assert lens.longitude_min == -math.pi and lens.longitude_max == math.pi

    def test_equirect_explicit(self):
        lens = cli.parse_equirectangular("-1,1,-0.5,0.5", 100, 50)
        assert lens.longitude_span == 2.0 and lens.latitude_span == 1.0

    def test_equirect_wrong_count(self):
        with pytest.raises(cli.CliError, match="expected 4 arguments"):
            cli.parse_equirectangular("-1,1", 100, 50)

    def test_rotation_default_is_identity(self):
        assert cli.parse_rotation("0.0") is not None  # builds fine
        rm = cli.parse_rotation("0.0")
        np.testing.assert_array_equal(rm, np.eye(3, dtype=F))


class TestSingleFileRuns:
    def test_fisheye_to_rect_png(self, tmp_path, capsys):
        # BASELINE config #1 shape: equidistant 180 -> rectilinear 35,36, bilinear.
        src_img = make_fisheye_png(tmp_path / "in.png", size=64)
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--single", str(tmp_path / "in.png"), "-o", str(out_dir), "--png",
            "--no-configs", "64,64", "--i-equidistant", "180",
            "--rectilinear", "35,36", "--bl",
        ])
        assert rc == 0
        assert (out_dir / "in.png").exists()

        # Validate against the oracle (through the PNG gamma roundtrip).
        back = png.read_png(str(tmp_path / "in.png"))
        # NOTE: CLI passes fov in *degrees*? No: reference --i-equidistant takes
        # fov as given; Blender configs use radians. 180 here means 180 radians
        # in the math — matching the reference's atof passthrough exactly.
        in_lens = FisheyeEquidistant(fov=180.0, sensor_width=36.0, sensor_height=36.0)
        out_lens = Rectilinear(35.0, 36.0, 36.0)
        want = oracle.oracle_remap(
            back.data, None, in_lens=in_lens, out_lens=out_lens,
            out_h=64, out_w=64, interp="bilinear", n_samples=1,
        )
        got = png.read_png(str(out_dir / "in.png")).data
        # Compare after the writer's quantization: re-encode oracle and read.
        png.write_png(str(tmp_path / "oracle.png"), want)
        want_rt = png.read_png(str(tmp_path / "oracle.png")).data
        np.testing.assert_allclose(got, want_rt, atol=1e-6)

    def test_exposure_reinhard_exr(self, tmp_path):
        img = make_fisheye_png(tmp_path / "in.png", size=32)
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--single", str(tmp_path / "in.png"), "-o", str(out_dir), "--exr",
            "--no-configs", "32,32", "--i-equirectangular", "full",
            "--rectilinear", "35,36", "--bc",
            "--exposure", "1.0", "--reinhard", "4.0",
        ])
        assert rc == 0
        got = exr.read_exr(str(out_dir / "in.exr")).data

        back = png.read_png(str(tmp_path / "in.png"))
        from image_lens_reproject_tpu.models.lens import full_equirectangular

        want = oracle.oracle_remap(
            back.data, None, in_lens=full_equirectangular(),
            out_lens=Rectilinear(35.0, 36.0, 36.0),
            out_h=32, out_w=32, interp="bicubic", n_samples=1,
        )
        want = oracle.oracle_post_process(want, 2.0, 4.0)  # 2^1.0 EV
        want = want.astype(np.float16).astype(F)  # EXR HALF
        np.testing.assert_allclose(got, want, atol=2e-3)

    def test_no_reproject_copies(self, tmp_path):
        make_fisheye_png(tmp_path / "in.png", size=16)
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--single", str(tmp_path / "in.png"), "-o", str(out_dir), "--png",
            "--no-configs", "16,16", "--i-equidistant", "180", "--no-reproject",
        ])
        assert rc == 0
        src = png.read_png(str(tmp_path / "in.png")).data
        got = png.read_png(str(out_dir / "in.png")).data
        np.testing.assert_allclose(got, src, atol=0.01)

    def test_no_reproject_output_resolution_resamples(self, tmp_path):
        # With --output-resolution the reference's `scale` stays 0.0
        # (src/main.cpp:297-310), so the plain-copy fast path (scale==1.0)
        # does not fire and --no-reproject resamples to the requested W,H.
        make_fisheye_png(tmp_path / "in.png", size=16)
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--single", str(tmp_path / "in.png"), "-o", str(out_dir), "--png",
            "--no-configs", "16,16", "--i-equidistant", "180",
            "--no-reproject", "--output-resolution", "8,8", "--bl",
        ])
        assert rc == 0
        got = png.read_png(str(out_dir / "in.png")).data
        assert got.shape == (8, 8, 3)


class TestDirectoryRuns:
    def test_batch_with_filters_and_skip(self, tmp_path, capsys):
        in_dir = tmp_path / "frames"
        in_dir.mkdir()
        for name in ["cam0_000.png", "cam0_001.png", "cam1_000.png", "notes.txt"]:
            if name.endswith(".png"):
                make_fisheye_png(in_dir / name, size=16)
            else:
                (in_dir / name).write_text("hi")
        out_dir = tmp_path / "out"
        args = [
            "-i", str(in_dir), "-o", str(out_dir), "--png",
            "--no-configs", "16,16", "--i-equidistant", "180",
            "--rectilinear", "35,36", "--bl",
            "--filter-prefix", "cam0", "-j", "2",
        ]
        assert cli.main(args) == 0
        assert (out_dir / "cam0_000.png").exists()
        assert (out_dir / "cam0_001.png").exists()
        assert not (out_dir / "cam1_000.png").exists()

        # Second run with --skip-if-exists skips everything.
        assert cli.main(args + ["--skip-if-exists"]) == 0
        out = capsys.readouterr().out
        assert "Skipping" in out


class TestConfigWorkflow:
    def cfg_file(self, tmp_path, resolution=(32, 32)):
        cfg = {
            "camera": {"type": "PERSP", "lens_unit": "MILLIMETERS", "focal_length": 50.0},
            "sensor_size": [36.0, 36.0],
            "resolution": list(resolution),
            "frames": [{"name": "in.exr"}, {"name": "other.exr"}],
            "blender_version": "3.0",
        }
        path = tmp_path / "in_cfg.json"
        path.write_text(json.dumps(cfg))
        return path

    def test_dry_run_writes_config_only(self, tmp_path, capsys):
        cfg_path = self.cfg_file(tmp_path)
        out_cfg = tmp_path / "out_cfg.json"
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--input-cfg", str(cfg_path), "--output-cfg", str(out_cfg),
            "--single", str(tmp_path / "in.exr"), "-o", str(out_dir), "--exr",
            "--equisolid", "15,36,3.14159", "--dry-run",
            "--filter-prefix", "in",
        ])
        assert rc == 0
        assert "Dry-run. Exiting." in capsys.readouterr().out
        saved = json.loads(out_cfg.read_text())
        assert saved["camera"]["panorama_type"] == "FISHEYE_EQUISOLID"
        assert saved["camera"]["fisheye_lens"] == 15.0
        assert saved["blender_version"] == "3.0"  # unknown key passthrough
        assert [f["name"] for f in saved["frames"]] == ["in.exr"]
        assert not (out_dir / "in.exr").exists()

    def test_config_exr_roundtrip_with_depth(self, tmp_path):
        # BASELINE config #4 shape: Blender JSON, EXR color+depth,
        # rectilinear -> equisolid.
        cfg_path = self.cfg_file(tmp_path)
        rng = np.random.default_rng(0)
        img = np.abs(rng.normal(0.5, 0.3, size=(32, 32, 4))).astype(F)
        exr.write_exr(str(tmp_path / "in.exr"), img, channel_names=["R", "G", "B", "Z"])
        out_cfg = tmp_path / "out_cfg.json"
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--input-cfg", str(cfg_path), "--output-cfg", str(out_cfg),
            "--single", str(tmp_path / "in.exr"), "-o", str(out_dir), "--exr",
            "--equisolid", "15,36,3.14159", "--bl",
        ])
        assert rc == 0
        got = exr.read_exr(str(out_dir / "in.exr"))
        assert got.data.shape == (32, 32, 4)

        from image_lens_reproject_tpu.models.lens import FisheyeEquisolid

        src = exr.read_exr(str(tmp_path / "in.exr"))
        want = oracle.oracle_remap(
            src.data, None,
            in_lens=Rectilinear(50.0, 36.0, 36.0),
            out_lens=FisheyeEquisolid(15.0, 3.14159, 36.0, 36.0),
            out_h=32, out_w=32, interp="bilinear", n_samples=1,
        ).astype(np.float16).astype(F)
        np.testing.assert_allclose(got.data, want, atol=2e-3)

    def test_scale(self, tmp_path):
        cfg_path = self.cfg_file(tmp_path, resolution=(32, 32))
        make_fisheye_png(tmp_path / "in.png", size=32)
        out_cfg = tmp_path / "out_cfg.json"
        out_dir = tmp_path / "out"
        rc = cli.main([
            "--input-cfg", str(cfg_path), "--output-cfg", str(out_cfg),
            "--single", str(tmp_path / "in.png"), "-o", str(out_dir), "--png",
            "--rectilinear", "35,36", "--scale", "0.5", "--bl",
        ])
        assert rc == 0
        got = png.read_png(str(out_dir / "in.png"))
        assert got.data.shape == (16, 16, 3)
        saved = json.loads(out_cfg.read_text())
        assert saved["resolution"] == [16, 16]
