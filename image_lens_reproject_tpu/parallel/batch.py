"""Multi-device sharded remap step (shard_map over a (batch, rows) mesh).

The full device-side "step" of the framework: a batch of source images,
sharded over devices, is reprojected + tonemapped into a sharded output
batch. Per-device work is a row-band of each output image; the only
collective is an all_gather of source row-bands along the ``rows`` axis
(tiled) because lens remaps gather globally from the source — for
full-360 equirectangular inputs the horizontal wrap makes every device's
band potentially read every source column, which is why the source is
gathered rather than halo-exchanged (SURVEY.md §5.7).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..models.lens import LensSpec
from ..ops import color as color_ops
from ..ops import remap as remap_ops
from .mesh import BATCH_AXIS, ROWS_AXIS, input_sharding


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "in_lens",
        "out_lens",
        "out_h",
        "out_w",
        "interp",
        "n_samples",
        "exposure",
        "reinhard",
        "in_h",
    ),
)
def sharded_remap_step(
    batch: jax.Array,
    rotation: Optional[jax.Array],
    *,
    mesh: Mesh,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    in_h: Optional[int] = None,
) -> jax.Array:
    """(B, H, W, C) sharded batch -> (B, out_h, out_w, C) sharded outputs.

    B must divide by mesh 'batch'. Neither height needs to divide by mesh
    'rows': output bands are padded to ceil(out_h / rows) and cropped at
    the end, and a source batch row-padded to the rows axis (pipeline
    pads with edge-replicated rows purely for even sharding transport)
    is sliced back to ``in_h`` after the all_gather, so the lens
    geometry always sees the true source height.
    """
    n_rows = mesh.shape[ROWS_AXIS]
    band = -(-out_h // n_rows)
    out_h_pad = band * n_rows
    if in_h is None:
        in_h = int(batch.shape[1])

    rot_spec = P() if rotation is not None else None

    def step(local_src, rot):
        # local_src: (B/b, H_pad/r, W, C). Gather full source rows, then
        # drop transport-only padding rows.
        full_src = jax.lax.all_gather(local_src, ROWS_AXIS, axis=1, tiled=True)
        if full_src.shape[1] != in_h:
            full_src = full_src[:, :in_h]
        row0 = jax.lax.axis_index(ROWS_AXIS) * band

        def one(img):
            out = remap_ops.remap_image(
                img,
                rot,
                in_lens=in_lens,
                out_lens=out_lens,
                out_h=out_h,
                out_w=out_w,
                interp=interp,
                n_samples=n_samples,
                row_offset=row0,
                row_count=band,
            )
            if exposure != 1.0 or reinhard != 1.0:
                out = color_ops.post_process(out, exposure, reinhard)
            return out

        return jax.vmap(one)(full_src)

    in_specs = (P(BATCH_AXIS, ROWS_AXIS, None, None), rot_spec)
    out_specs = P(BATCH_AXIS, ROWS_AXIS, None, None)
    if rotation is None:
        fn = jax.shard_map(
            lambda s: step(s, None), mesh=mesh, in_specs=(in_specs[0],),
            out_specs=out_specs,
        )
        result = fn(batch)
    else:
        fn = jax.shard_map(
            step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        )
        result = fn(batch, rotation)
    return result[:, :out_h] if out_h_pad != out_h else result


def shard_batch(batch, mesh: Mesh):
    """Place a host (B, H, W, C) batch with (batch, rows) input sharding."""
    return jax.device_put(batch, input_sharding(mesh))
