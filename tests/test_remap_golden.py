"""Golden tests: jitted device remap vs the float32 numpy oracle.

Three layers (SURVEY.md §4 test pyramid):
1. sampler parity at given coordinates (exact index semantics incl.
   truncation-toward-zero, wrap, clamp, edge fractions);
2. source-coordinate-field parity (pixel-level tolerance);
3. end-to-end remap on smooth images, max-abs-err well under the 1e-3
   parity budget from BASELINE.md.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from image_lens_reproject_tpu.models.lens import (
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    Rectilinear,
    full_equirectangular,
)
from image_lens_reproject_tpu.models.rotation import rotation_matrix_degrees
from image_lens_reproject_tpu.ops import color, remap, remap_fused, sampling
from image_lens_reproject_tpu.utils import oracle

F = np.float32


def smooth_image(h, w, c, seed=0):
    """Low-frequency smooth test image: tap-shift errors stay ~O(1/max(h,w))."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=F), np.linspace(0, 1, w, dtype=F), indexing="ij"
    )
    chans = []
    for i in range(c):
        a, b, p = rng.uniform(0.5, 2.0, size=3)
        chans.append(0.5 + 0.45 * np.sin(a * 4 * xx + b * 3 * yy + p))
    return np.stack(chans, axis=-1).astype(F)


RECT = Rectilinear(focal_length=35.0, sensor_width=36.0, sensor_height=27.0)
EQUIDIST = FisheyeEquidistant(fov=math.pi, sensor_width=36.0, sensor_height=36.0)
EQUISOLID = FisheyeEquisolid(
    focal_length=15.0, fov=math.pi, sensor_width=36.0, sensor_height=36.0
)
EQUIRECT = full_equirectangular()
STEREO = FisheyeStereographic(
    focal_length=10.0, fov=math.pi, sensor_width=36.0, sensor_height=36.0
)

LENSES = {
    "rect": RECT,
    "equidist": EQUIDIST,
    "equisolid": EQUISOLID,
    "stereo": STEREO,
    "equirect": EQUIRECT,
}
# Every (input lens, output lens) pair of the five lens types.
LENS_PAIRS = [
    pytest.param(LENSES[a], LENSES[b], id=f"{a}-{b}") for a in LENSES for b in LENSES
]


class TestSamplerParity:
    """Samplers fed identical coordinates must match the oracle exactly-ish."""

    @pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
    @pytest.mark.parametrize("wrap", [False, True])
    def test_random_coords(self, interp, wrap):
        rng = np.random.default_rng(42)
        src = rng.uniform(0, 1, size=(19, 23, 3)).astype(F)
        # Include out-of-bounds, negative, and near-integer coordinates.
        sx = rng.uniform(-6, 29, size=(200,)).astype(F)
        sy = rng.uniform(-6, 25, size=(200,)).astype(F)
        sx = np.concatenate([sx, np.arange(-3, 26, dtype=F), np.arange(-3, 26, dtype=F) + F(0.5)])
        sy = np.concatenate([sy, np.arange(-3, 26, dtype=F), np.arange(-3, 26, dtype=F) + F(0.25)])

        got = np.asarray(
            sampling.sample(jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy), interp, wrap)
        )
        want = oracle.oracle_sample(src, sx, sy, interp, wrap)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_nearest_exact_at_centers(self):
        src = np.arange(5 * 7 * 2, dtype=F).reshape(5, 7, 2)
        sx = np.array([0.0, 6.0, 3.0], dtype=F)
        sy = np.array([0.0, 4.0, 2.0], dtype=F)
        got = np.asarray(sampling.sample(jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy), "nearest", False))
        np.testing.assert_array_equal(got[0], src[0, 0])
        np.testing.assert_array_equal(got[1], src[4, 6])
        np.testing.assert_array_equal(got[2], src[2, 3])

    def test_wrap_modulo(self):
        src = np.arange(4 * 8 * 1, dtype=F).reshape(4, 8, 1)
        # sx = 7.75 bilinear: lx=7, ux=trunc(8.75)=8 -> wrap 0
        got = np.asarray(sampling.sample(jnp.asarray(src), jnp.asarray(F(7.75)), jnp.asarray(F(1.0)), "bilinear", True))
        want = 0.25 * src[1, 7, 0] + 0.75 * src[1, 0, 0]
        # fx computed against lx=7: fx = 0.75 -> val = 0.25*src[7] + 0.75*src[0]
        np.testing.assert_allclose(got[0], want, atol=1e-6)


class TestCoordinateField:
    @pytest.mark.parametrize("in_lens,out_lens", LENS_PAIRS)
    def test_jnp_vs_oracle_coords(self, in_lens, out_lens):
        out_h, out_w, in_h, in_w = 36, 64, 48, 96
        cx = (np.arange(out_w, dtype=F) + F(0.5)) - F(out_w * 0.5)
        cy = (np.arange(out_h, dtype=F) + F(0.5)) - F(out_h * 0.5)
        rot = rotation_matrix_degrees(10.0, -5.0, 3.0)

        sxn, syn = remap.source_coords(
            in_lens, out_lens, in_h, in_w, cx[None, :], cy[:, None], rot, out_h, out_w, xp=np
        )
        sxj, syj = remap.source_coords(
            in_lens, out_lens, in_h, in_w,
            jnp.asarray(cx)[None, :], jnp.asarray(cy)[:, None],
            jnp.asarray(rot), out_h, out_w, xp=jnp,
        )
        # Coordinates far outside the source image are clamped by the
        # samplers (or explode to inf for rectilinear inputs near the
        # horizon where -z -> 0); only the in-range values affect output.
        def clipped(v, hi):
            return np.clip(np.asarray(v, dtype=np.float64), -16.0, hi + 16.0)

        np.testing.assert_allclose(
            clipped(sxj, in_w), clipped(np.broadcast_to(sxn, (out_h, out_w)), in_w), atol=2e-3
        )
        np.testing.assert_allclose(
            clipped(syj, in_h), clipped(np.broadcast_to(syn, (out_h, out_w)), in_h), atol=2e-3
        )


class TestEndToEnd:
    @pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
    @pytest.mark.parametrize("in_lens,out_lens", LENS_PAIRS)
    def test_remap_matches_oracle(self, interp, in_lens, out_lens):
        # A small rotation keeps same-lens pairs off exact half-pixel
        # coordinates, where nearest's round-half tie flips on the last bit.
        src = smooth_image(48, 96, 3, seed=1)
        rot = rotation_matrix_degrees(3.0, -2.0, 1.0)
        got = np.asarray(
            remap.remap_jit(
                jnp.asarray(src), jnp.asarray(rot),
                in_lens=in_lens, out_lens=out_lens,
                out_h=40, out_w=72, interp=interp, n_samples=1,
            )
        )
        want = oracle.oracle_remap(
            src, rot, in_lens=in_lens, out_lens=out_lens,
            out_h=40, out_w=72, interp=interp, n_samples=1,
        )
        assert got.shape == want.shape == (40, 72, 3)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_supersampling(self):
        src = smooth_image(40, 80, 3, seed=2)
        for n in (2, 3):
            got = np.asarray(
                remap.remap_jit(
                    jnp.asarray(src), None,
                    in_lens=EQUIRECT, out_lens=RECT,
                    out_h=24, out_w=32, interp="bilinear", n_samples=n,
                )
            )
            want = oracle.oracle_remap(
                src, None, in_lens=EQUIRECT, out_lens=RECT,
                out_h=24, out_w=32, interp="bilinear", n_samples=n,
            )
            np.testing.assert_allclose(got, want, atol=1e-3)

    def test_rotation_end_to_end(self):
        src = smooth_image(48, 96, 3, seed=3)
        rot = rotation_matrix_degrees(25.0, 10.0, -7.0)
        got = np.asarray(
            remap.remap_jit(
                jnp.asarray(src), jnp.asarray(rot),
                in_lens=EQUIRECT, out_lens=RECT,
                out_h=32, out_w=48, interp="bicubic", n_samples=1,
            )
        )
        want = oracle.oracle_remap(
            src, rot, in_lens=EQUIRECT, out_lens=RECT,
            out_h=32, out_w=48, interp="bicubic", n_samples=1,
        )
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_batch_matches_single(self):
        src = np.stack([smooth_image(32, 64, 3, seed=s) for s in range(4)])
        batch = np.asarray(
            remap.remap_batch_jit(
                jnp.asarray(src), None,
                in_lens=EQUIRECT, out_lens=RECT,
                out_h=24, out_w=32, interp="bilinear", n_samples=1,
            )
        )
        for i in range(4):
            single = np.asarray(
                remap.remap_jit(
                    jnp.asarray(src[i]), None,
                    in_lens=EQUIRECT, out_lens=RECT,
                    out_h=24, out_w=32, interp="bilinear", n_samples=1,
                )
            )
            np.testing.assert_allclose(batch[i], single, atol=1e-6)

    def test_channels_4_and_5(self):
        for c in (4, 5):
            src = smooth_image(32, 64, c, seed=c)
            got = np.asarray(
                remap.remap_jit(
                    jnp.asarray(src), None,
                    in_lens=EQUIRECT, out_lens=RECT,
                    out_h=16, out_w=24, interp="bilinear", n_samples=1,
                )
            )
            want = oracle.oracle_remap(
                src, None, in_lens=EQUIRECT, out_lens=RECT,
                out_h=16, out_w=24, interp="bilinear", n_samples=1,
            )
            np.testing.assert_allclose(got, want, atol=1e-3)


class TestRemapTonemap:
    """The fused entry point against the oracle remap + post-process."""

    @pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
    @pytest.mark.parametrize("channels", [1, 3, 4, 5])
    def test_matches_oracle(self, channels, interp):
        src = smooth_image(48, 96, channels, seed=30 + channels) * 2.0
        rot = rotation_matrix_degrees(12.0, 4.0, -2.0)
        kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=40, out_w=72,
                  interp=interp, n_samples=1)
        got = np.asarray(remap_fused.remap_tonemap(
            jnp.asarray(src), jnp.asarray(rot), exposure=2.0, reinhard=4.0, **kw))
        want = oracle.oracle_post_process(
            oracle.oracle_remap(src, rot, **kw), 2.0, 4.0)
        assert got.shape == want.shape == (40, 72, channels)
        np.testing.assert_allclose(got, want, atol=1e-3)


class TestRowBands:
    """A banded remap (row_offset/row_count) equals the same rows of the
    full image, including a last band cut short by out_h."""

    @pytest.mark.parametrize("out_h,band", [(24, 8), (30, 8), (31, 7), (17, 5), (9, 9)])
    def test_bands_compose_to_full(self, out_h, band):
        src = smooth_image(48, 96, 3, seed=40)
        rot = rotation_matrix_degrees(-8.0, 6.0, 2.0)
        kw = dict(in_lens=EQUISOLID, out_lens=EQUIRECT, out_h=out_h, out_w=40,
                  interp="bicubic", n_samples=1)
        full = np.asarray(remap.remap_jit(jnp.asarray(src), jnp.asarray(rot), **kw))
        bands = [
            np.asarray(remap.remap_image(
                jnp.asarray(src), jnp.asarray(rot), row_offset=jnp.int32(r0),
                row_count=band, **kw))
            for r0 in range(0, out_h, band)
        ]
        banded = np.concatenate(bands, axis=0)
        assert banded.shape[0] == -(-out_h // band) * band
        np.testing.assert_allclose(banded[:out_h], full, atol=1e-5)


class TestPostProcess:
    def test_matches_oracle(self):
        img = smooth_image(16, 16, 5, seed=9) * 3.0  # HDR-ish range
        got = np.asarray(color.post_process_jit(jnp.asarray(img), exposure=2.0, reinhard=4.0))
        want = oracle.oracle_post_process(img, 2.0, 4.0)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_alpha_depth_untouched(self):
        img = smooth_image(8, 8, 5, seed=10)
        got = np.asarray(color.post_process_jit(jnp.asarray(img), exposure=4.0, reinhard=2.0))
        np.testing.assert_array_equal(got[..., 3:], img[..., 3:])
        assert not np.allclose(got[..., :3], img[..., :3])

    def test_reinhard_formula(self):
        img = np.full((2, 2, 3), 0.5, dtype=F)
        got = np.asarray(color.post_process_jit(jnp.asarray(img), exposure=1.0, reinhard=1.0))
        v = 0.5
        want = v * (1 + v) / (1 + v)
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestPartialEquirect:
    """Arbitrary lat/long segments (clamp mode — not full-360, no wrap)."""

    PART = __import__(
        "image_lens_reproject_tpu.models.lens", fromlist=["Equirectangular"]
    ).Equirectangular(
        longitude_min=-1.2, longitude_max=0.8,
        latitude_min=-0.6, latitude_max=0.9,
    )

    @pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
    def test_partial_input_matches_oracle(self, interp):
        src = smooth_image(48, 96, 3, seed=21)
        kw = dict(in_lens=self.PART, out_lens=Rectilinear(35.0, 36.0, 27.0),
                  out_h=40, out_w=72, interp=interp, n_samples=1)
        got = np.asarray(remap.remap_jit(jnp.asarray(src), None, **kw))
        want = oracle.oracle_remap(src, None, **kw)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_partial_output_matches_oracle(self):
        src = smooth_image(48, 96, 3, seed=22)
        kw = dict(in_lens=full_equirectangular(), out_lens=self.PART,
                  out_h=40, out_w=72, interp="bilinear", n_samples=1)
        rot = rotation_matrix_degrees(10.0, 5.0, 0.0)
        got = np.asarray(remap.remap_jit(jnp.asarray(src), jnp.asarray(rot), **kw))
        want = oracle.oracle_remap(src, rot, **kw)
        np.testing.assert_allclose(got, want, atol=1e-3)


class TestRoundTrip:
    """A->B->A ~= identity away from poles/FOV edges (SURVEY.md §4 item 3)."""

    def test_equirect_rect_equirect(self):
        # Central rectilinear view covers the central equirect region; check
        # the region that stays inside the intermediate view's FOV.
        eq = full_equirectangular()
        rect = Rectilinear(18.0, 36.0, 27.0)  # wide FOV (~90 deg)
        src = smooth_image(64, 128, 3, seed=23)
        mid = remap.remap_jit(
            jnp.asarray(src), None, in_lens=eq, out_lens=rect,
            out_h=192, out_w=256, interp="bilinear", n_samples=1,
        )
        back = np.asarray(remap.remap_jit(
            mid, None, in_lens=rect, out_lens=eq,
            out_h=64, out_w=128, interp="bilinear", n_samples=1,
        ))
        # central crop: ~±30 deg of the forward axis
        region = (slice(26, 38), slice(54, 74))
        err = np.abs(back[region] - src[region])
        assert err.max() < 0.02, err.max()

    def test_equidist_equirect_equidist_mirrors(self):
        # Reference quirk (SURVEY.md §2.1): the equidistant forward ray
        # points BACKWARD (+cos theta, src/reproject.cpp:171-206) and the
        # inverse divides by -z unguarded, so vec_to(target_to_vec(p)) = -p
        # — a fisheye round trip returns the POINT-REFLECTED image. Pin it.
        ed = FisheyeEquidistant(math.pi, 36.0, 36.0)
        eq = full_equirectangular()
        src = smooth_image(96, 96, 3, seed=24)
        mid = remap.remap_jit(
            jnp.asarray(src), None, in_lens=ed, out_lens=eq,
            out_h=256, out_w=512, interp="bilinear", n_samples=1,
        )
        back = np.asarray(remap.remap_jit(
            mid, None, in_lens=eq, out_lens=ed,
            out_h=96, out_w=96, interp="bilinear", n_samples=1,
        ))
        # Small central disc: a second reference quirk (the equirect
        # forward ray's missing cos(lat) only partially compensated by the
        # asin inverse) warps the round trip increasingly off-axis, so only
        # the near-axis region returns cleanly (err ~0.10 at theta=45 deg).
        yy, xx = np.mgrid[0:96, 0:96]
        disc = (xx - 47.5) ** 2 + (yy - 47.5) ** 2 < 12 ** 2
        mirrored = src[::-1, ::-1]  # point reflection through the center
        err = np.abs(back - mirrored).max(axis=-1)
        assert err[disc].max() < 0.02, err[disc].max()
