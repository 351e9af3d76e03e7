"""The fused reprojection remap — the framework's compute core.

Re-design of the reference's triple-templated per-pixel loop
``reproject_from_to_with_interpolation`` (reference src/reproject.cpp:273-346)
and its dispatch pyramid (348-419). The scalar loop becomes one traced
function: a dense coordinate-field computation (pixel -> ray -> rotate ->
source pixel, all elementwise math that XLA fuses) followed by a
vectorized gather-interpolate. Lens types, interpolation mode, wrap flag
and supersample count are *static* jit arguments, so each combination
specializes at compile time — the analog of the reference's 36 template
instantiations, but generated by XLA instead of the C++ compiler.

Supersampling (reference src/reproject.cpp:294-341): n x n stratified
sub-pixel offsets ``(ss+1)/(n+1) - 0.5``, accumulated then normalized by
1/n². The accumulation is an unrolled static Python loop so peak memory
stays one (H, W, C) accumulator regardless of n.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import projections
from ..models.lens import LensSpec, wrap_mode_for_input
from . import sampling

Array = Any


def supersample_offsets(n_samples: int):
    """Stratified sub-pixel offsets (reference src/reproject.cpp:295, 298)."""
    return [
        np.float32((ss + 1.0) / (n_samples + 1.0) - 0.5) for ss in range(n_samples)
    ]


def source_coords(
    in_lens: LensSpec,
    out_lens: LensSpec,
    in_h: int,
    in_w: int,
    scx: Array,
    scy: Array,
    rotation: Optional[Array],
    out_h: int,
    out_w: int,
    xp=jnp,
):
    """Output-pixel-centered coords -> top-left-aligned source coords.

    The straight-line pipeline of the reference's inner loop body
    (src/reproject.cpp:300-324): unproject, rotate, project, shift.
    """
    vx, vy, vz = projections.target_to_vec(
        out_lens, float(out_w), float(out_h), scx, scy, xp=xp
    )
    if rotation is not None:
        r = rotation
        nx = r[0, 0] * vx + r[0, 1] * vy + r[0, 2] * vz
        ny = r[1, 0] * vx + r[1, 1] * vy + r[1, 2] * vz
        nz = r[2, 0] * vx + r[2, 1] * vy + r[2, 2] * vz
        vx, vy, vz = nx, ny, nz
    sx, sy = projections.vec_to_source(in_lens, float(in_w), float(in_h), vx, vy, vz, xp=xp)
    # Back to top-left aligned source coordinates (src/reproject.cpp:323-324).
    sx = (sx - xp.float32(0.5)) + xp.float32(in_w * 0.5)
    sy = (sy - xp.float32(0.5)) + xp.float32(in_h * 0.5)
    return sx, sy


def remap_image(
    src: Array,
    rotation: Optional[Array],
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    row_offset=None,
    row_count: Optional[int] = None,
    xp=jnp,
) -> Array:
    """Reproject one (H_in, W_in, C) image to (row_count, out_w, C).

    Pure function of its inputs; trace-compatible with jnp (device path)
    and numpy (float32 oracle path for tests). ``rotation`` is a (3, 3)
    float32 matrix or None to skip the rotate stage entirely (the
    reference passes identity and always multiplies; results are
    identical). With row_offset/row_count the function computes only a
    band of output rows (spatial sharding / tiling); defaults compute the
    full image.
    """
    in_h, in_w = int(src.shape[0]), int(src.shape[1])
    wrap = wrap_mode_for_input(in_lens)

    # Pixel centers, image centered on (0, 0) (src/reproject.cpp:287-288).
    # row_offset/row_count select a horizontal band of the *output* —
    # the unit of spatial sharding across devices (SURVEY.md §5.7): each
    # device computes rows [row_offset, row_offset + row_count) of the
    # full out_h x out_w grid. row_offset may be a traced scalar
    # (jax.lax.axis_index under shard_map).
    if row_count is None:
        row_count = out_h
    cx = (xp.arange(out_w, dtype=xp.float32) + xp.float32(0.5)) - xp.float32(out_w * 0.5)
    cy = (xp.arange(row_count, dtype=xp.float32) + xp.float32(0.5)) - xp.float32(out_h * 0.5)
    if row_offset is not None:
        cy = cy + xp.float32(1.0) * row_offset
    cx = cx[None, :]  # (1, W)
    cy = cy[:, None]  # (rows, 1)

    offsets = supersample_offsets(n_samples)
    acc = None
    for off_x in offsets:
        for off_y in offsets:
            sx, sy = source_coords(
                in_lens, out_lens, in_h, in_w,
                cx + off_x, cy + off_y,
                rotation, out_h, out_w, xp=xp,
            )
            tap = sampling.sample(src, sx, sy, interp, wrap, xp=xp)
            acc = tap if acc is None else acc + tap

    normalize = xp.float32(1.0 / (n_samples * n_samples))
    return acc * normalize


@functools.partial(
    jax.jit,
    static_argnames=("in_lens", "out_lens", "out_h", "out_w", "interp", "n_samples"),
)
def remap_jit(
    src: jax.Array,
    rotation: Optional[jax.Array],
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str,
    n_samples: int,
) -> jax.Array:
    """Jitted single-image remap, specialized per static lens/interp combo."""
    return remap_image(
        src,
        rotation,
        in_lens=in_lens,
        out_lens=out_lens,
        out_h=out_h,
        out_w=out_w,
        interp=interp,
        n_samples=n_samples,
        xp=jnp,
    )


@functools.partial(
    jax.jit,
    static_argnames=("in_lens", "out_lens", "out_h", "out_w", "interp", "n_samples"),
)
def remap_batch_jit(
    src: jax.Array,
    rotation: Optional[jax.Array],
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str,
    n_samples: int,
) -> jax.Array:
    """Batched remap: (B, H_in, W_in, C) -> (B, out_h, out_w, C).

    The source-coordinate field is identical for every image in the batch
    (the reference recomputes it per image on each pool thread,
    src/main.cpp:536-622); vmap reuses one coordinate computation across
    the batch dimension and turns the per-tap gathers into batched gathers.
    """
    fn = functools.partial(
        remap_image,
        in_lens=in_lens,
        out_lens=out_lens,
        out_h=out_h,
        out_w=out_w,
        interp=interp,
        n_samples=n_samples,
        xp=jnp,
    )
    return jax.vmap(lambda im: fn(im, rotation))(src)
