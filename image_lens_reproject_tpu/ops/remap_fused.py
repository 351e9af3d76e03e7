"""Fused remap + tonemap: the framework's single-image hot entry point.

One jitted program: coordinate field -> rotate -> project -> gather
interpolate -> exposure/Reinhard. XLA fuses the elementwise stages around
the ``jnp.take`` gathers into one device program.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax

from ..models.lens import LensSpec
from . import color as color_ops
from . import remap as remap_ops


@functools.partial(
    jax.jit,
    static_argnames=(
        "in_lens",
        "out_lens",
        "out_h",
        "out_w",
        "interp",
        "n_samples",
        "exposure",
        "reinhard",
    ),
)
def remap_tonemap(
    src: jax.Array,
    rotation: Optional[jax.Array],
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
) -> jax.Array:
    """(H, W, C) -> (out_h, out_w, C), remap + optional tonemap, one program."""
    out = remap_ops.remap_image(
        src,
        rotation,
        in_lens=in_lens,
        out_lens=out_lens,
        out_h=out_h,
        out_w=out_w,
        interp=interp,
        n_samples=n_samples,
    )
    if exposure != 1.0 or reinhard != 1.0:
        out = color_ops.post_process(out, exposure, reinhard)
    return out
