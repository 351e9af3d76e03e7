"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates that the shard_map remap step (all_gather of source bands +
row-band compute) produces bit-identical results to the single-device
path, across mesh layouts — the SURVEY.md §4(6) multi-device test strategy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_lens_reproject_tpu.models.lens import (
    FisheyeEquidistant,
    Rectilinear,
    full_equirectangular,
)
from image_lens_reproject_tpu.models.rotation import rotation_matrix_degrees
from image_lens_reproject_tpu.ops import remap
from image_lens_reproject_tpu.parallel import batch as pbatch
from image_lens_reproject_tpu.parallel import mesh as pmesh

F = np.float32

RECT = Rectilinear(35.0, 36.0, 27.0)
EQUIRECT = full_equirectangular()


def smooth_batch(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=F), np.linspace(0, 1, w, dtype=F), indexing="ij"
    )
    out = np.empty((b, h, w, c), dtype=F)
    for i in range(b):
        for j in range(c):
            a, bb, p = rng.uniform(0.5, 2.0, size=3)
            out[i, :, :, j] = 0.5 + 0.45 * np.sin(a * 4 * xx + bb * 3 * yy + p + i)
    return out


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single(mesh_shape):
    b_axis, r_axis = mesh_shape
    mesh = pmesh.make_mesh(batch=b_axis, rows=r_axis)
    B, H, W, C = b_axis, 32, 64, 3
    out_h, out_w = 24, 48
    src = smooth_batch(B, H, W, C, seed=1)
    rot = rotation_matrix_degrees(15.0, -4.0, 2.0)

    sharded_src = pbatch.shard_batch(jnp.asarray(src), mesh)
    got = np.asarray(
        pbatch.sharded_remap_step(
            sharded_src,
            jnp.asarray(rot),
            mesh=mesh,
            in_lens=EQUIRECT,
            out_lens=RECT,
            out_h=out_h,
            out_w=out_w,
            interp="bilinear",
            n_samples=1,
        )
    )

    want = np.asarray(
        remap.remap_batch_jit(
            jnp.asarray(src),
            jnp.asarray(rot),
            in_lens=EQUIRECT,
            out_lens=RECT,
            out_h=out_h,
            out_w=out_w,
            interp="bilinear",
            n_samples=1,
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_with_tonemap_and_wrap_bicubic():
    mesh = pmesh.make_mesh(batch=2, rows=4)
    B = 2
    src = smooth_batch(B, 40, 80, 4, seed=2) * 2.0  # HDR, wrap input (equirect full)
    sharded_src = pbatch.shard_batch(jnp.asarray(src), mesh)
    got = np.asarray(
        pbatch.sharded_remap_step(
            sharded_src,
            None,
            mesh=mesh,
            in_lens=EQUIRECT,
            out_lens=RECT,
            out_h=32,
            out_w=32,
            interp="bicubic",
            n_samples=2,
            exposure=2.0,
            reinhard=4.0,
        )
    )
    from image_lens_reproject_tpu.ops import color

    want = remap.remap_batch_jit(
        jnp.asarray(src), None,
        in_lens=EQUIRECT, out_lens=RECT,
        out_h=32, out_w=32, interp="bicubic", n_samples=2,
    )
    want = np.asarray(color.post_process_jit(want, exposure=2.0, reinhard=4.0))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_nondivisible_out_h():
    # out_h=30 with rows=4: bands pad to 8 rows each and the result is
    # cropped — results must exactly match the single-device path.
    mesh = pmesh.make_mesh(batch=2, rows=4)
    B, out_h, out_w = 2, 30, 48
    src = smooth_batch(B, 32, 64, 3, seed=9)
    rot = rotation_matrix_degrees(10.0, 3.0, -2.0)
    sharded_src = pbatch.shard_batch(jnp.asarray(src), mesh)
    got = np.asarray(
        pbatch.sharded_remap_step(
            sharded_src, jnp.asarray(rot), mesh=mesh,
            in_lens=EQUIRECT, out_lens=RECT,
            out_h=out_h, out_w=out_w, interp="bilinear", n_samples=1,
        )
    )
    assert got.shape == (B, out_h, out_w, 3)
    want = np.asarray(
        remap.remap_batch_jit(
            jnp.asarray(src), jnp.asarray(rot),
            in_lens=EQUIRECT, out_lens=RECT,
            out_h=out_h, out_w=out_w, interp="bilinear", n_samples=1,
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_row_band_offsets():
    """remap_image row banding composes to the full image (traced offsets)."""
    src = smooth_batch(1, 32, 64, 3, seed=3)[0]
    full = np.asarray(
        remap.remap_jit(
            jnp.asarray(src), None,
            in_lens=EQUIRECT, out_lens=RECT,
            out_h=24, out_w=32, interp="bilinear", n_samples=1,
        )
    )
    bands = []
    for r0 in range(0, 24, 8):
        band = remap.remap_image(
            jnp.asarray(src), None,
            in_lens=EQUIRECT, out_lens=RECT,
            out_h=24, out_w=32, interp="bilinear", n_samples=1,
            row_offset=jnp.int32(r0), row_count=8,
        )
        bands.append(np.asarray(band))
    np.testing.assert_allclose(np.concatenate(bands, axis=0), full, atol=1e-6)


def test_mesh_validation():
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_mesh(batch=3, rows=3)


def test_sharded_tall_window_equisolid():
    # Row-band sharding on equisolid -> equirect: the polar arcs read
    # source rows far from each device's output band under shard_map.
    from image_lens_reproject_tpu.models.lens import FisheyeEquisolid

    mesh = pmesh.make_mesh(batch=2, rows=4)
    es = FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)
    src = smooth_batch(2, 64, 64, 3, seed=5)
    rot = rotation_matrix_degrees(30.0, 10.0, 5.0)

    sharded_src = pbatch.shard_batch(jnp.asarray(src), mesh)
    got = np.asarray(
        pbatch.sharded_remap_step(
            sharded_src, jnp.asarray(rot), mesh=mesh,
            in_lens=es, out_lens=EQUIRECT, out_h=32, out_w=128,
            interp="bilinear", n_samples=1,
        )
    )
    want = np.asarray(
        remap.remap_batch_jit(
            jnp.asarray(src), jnp.asarray(rot),
            in_lens=es, out_lens=EQUIRECT, out_h=32, out_w=128,
            interp="bilinear", n_samples=1,
        )
    )
    err = np.abs(got - want)
    assert np.quantile(err, 0.999) < 1e-4
