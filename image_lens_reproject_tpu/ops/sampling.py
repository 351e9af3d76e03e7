"""Gather-based interpolation samplers (nearest / bilinear / bicubic).

Re-design of the reference's scalar per-pixel samplers
(reference src/reproject.cpp:37-148). Each sampler here is a *vectorized
gather*: tap indices are computed for a whole coordinate field at once,
pixels are fetched with one flat `take` per tap, and tap weights are
applied as fused elementwise math. XLA fuses the index arithmetic and
weighting; the gathers are the only memory-bound ops.

Index semantics replicated exactly from the reference:

* Truncation toward zero (C's ``int(float)`` cast), NOT floor —
  reference src/reproject.cpp:43-47, 60-67, 113-127.
* Horizontal wrap (full-360 equirect input): ``(int(s) + W) % W``
  (src/reproject.cpp:43, 60-61, 114-117). We use non-negative (floor)
  modulo, which equals the C expression whenever ``int(s) + W >= 0`` and —
  unlike C, whose result would be a negative out-of-bounds index — stays a
  valid index for coordinates below ``-W``.
* Clamp-to-edge otherwise; vertical always clamps.
* Interpolation fractions are computed against the already wrapped/clamped
  low tap index and clamped to [0, 1] (src/reproject.cpp:70-71, 130-131).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

Array = Any

INTERPOLATIONS = ("nearest", "bilinear", "bicubic")


def _trunc_i32(xp, v: Array) -> Array:
    """C's (int) cast: truncation toward zero."""
    return xp.trunc(v).astype(xp.int32)


def _wrap_w(xp, i: Array, width: int) -> Array:
    return (i + width) % width


def _clamp(xp, i: Array, hi: int) -> Array:
    return xp.clip(i, 0, hi)


def _gather(xp, flat_src: Array, ly: Array, lx: Array, width: int) -> Array:
    """Fetch (..., C) pixels from (H*W, C) at integer row/col indices."""
    idx = ly * width + lx
    if xp is jnp:
        return jnp.take(flat_src, idx, axis=0)
    return flat_src[idx]


def sample_nearest(src: Array, sx: Array, sy: Array, wrap: bool, xp=jnp) -> Array:
    """Nearest: round via int(s + 0.5) (reference src/reproject.cpp:40-53)."""
    h, w = src.shape[0], src.shape[1]
    flat = src.reshape(h * w, src.shape[2])
    half = xp.float32(0.5)
    lx = _trunc_i32(xp, sx + half)
    lx = _wrap_w(xp, lx, w) if wrap else _clamp(xp, lx, w - 1)
    ly = _clamp(xp, _trunc_i32(xp, sy + half), h - 1)
    return _gather(xp, flat, ly, lx, w)


def sample_bilinear(src: Array, sx: Array, sy: Array, wrap: bool, xp=jnp) -> Array:
    """4-tap bilinear (reference src/reproject.cpp:55-90)."""
    h, w = src.shape[0], src.shape[1]
    flat = src.reshape(h * w, src.shape[2])
    one = xp.float32(1.0)

    lx = _trunc_i32(xp, sx)
    ux = _trunc_i32(xp, sx + one)
    if wrap:
        lx, ux = _wrap_w(xp, lx, w), _wrap_w(xp, ux, w)
    else:
        lx, ux = _clamp(xp, lx, w - 1), _clamp(xp, ux, w - 1)
    ly = _clamp(xp, _trunc_i32(xp, sy), h - 1)
    uy = _clamp(xp, _trunc_i32(xp, sy + one), h - 1)

    fx = xp.clip(sx - lx.astype(xp.float32), xp.float32(0.0), one)[..., None]
    fy = xp.clip(sy - ly.astype(xp.float32), xp.float32(0.0), one)[..., None]

    ll = _gather(xp, flat, ly, lx, w)
    lu = _gather(xp, flat, ly, ux, w)
    ul = _gather(xp, flat, uy, lx, w)
    uu = _gather(xp, flat, uy, ux, w)

    lo = fx * lu + (one - fx) * ll
    up = fx * uu + (one - fx) * ul
    return fy * up + (one - fy) * lo


def cubic_weights(xp, t: Array):
    """Catmull-Rom-family weights matching the reference's Horner cubic.

    cubic(p, t) = p1 + 0.5 t (p2 - p0 + t (2 p0 - 5 p1 + 4 p2 - p3
                  + t (3 (p1 - p2) + p3 - p0)))   (src/reproject.cpp:92-98)
    expanded into per-tap weights so taps become a weighted gather sum.
    """
    half = xp.float32(0.5)
    t2 = t * t
    t3 = t2 * t
    w0 = half * (-t + xp.float32(2.0) * t2 - t3)
    w1 = xp.float32(1.0) + half * (xp.float32(-5.0) * t2 + xp.float32(3.0) * t3)
    w2 = half * (t + xp.float32(4.0) * t2 - xp.float32(3.0) * t3)
    w3 = half * (-t2 + t3)
    return w0, w1, w2, w3


def sample_bicubic(src: Array, sx: Array, sy: Array, wrap: bool, xp=jnp) -> Array:
    """16-tap separable bicubic (reference src/reproject.cpp:100-148)."""
    h, w = src.shape[0], src.shape[1]
    flat = src.reshape(h * w, src.shape[2])
    one = xp.float32(1.0)

    xs = []
    for k in (-1.0, 0.0, 1.0, 2.0):
        xi = _trunc_i32(xp, sx + xp.float32(k))
        xs.append(_wrap_w(xp, xi, w) if wrap else _clamp(xp, xi, w - 1))
    ys = [
        _clamp(xp, _trunc_i32(xp, sy + xp.float32(k)), h - 1)
        for k in (-1.0, 0.0, 1.0, 2.0)
    ]

    fx = xp.clip(sx - xs[1].astype(xp.float32), xp.float32(0.0), one)
    fy = xp.clip(sy - ys[1].astype(xp.float32), xp.float32(0.0), one)
    wx = cubic_weights(xp, fx)
    wy = cubic_weights(xp, fy)

    acc = None
    for yi in range(4):
        row = None
        for xi in range(4):
            tap = _gather(xp, flat, ys[yi], xs[xi], w) * wx[xi][..., None]
            row = tap if row is None else row + tap
        row = row * wy[yi][..., None]
        acc = row if acc is None else acc + row
    return acc


SAMPLERS = {
    "nearest": sample_nearest,
    "bilinear": sample_bilinear,
    "bicubic": sample_bicubic,
}


def sample(src: Array, sx: Array, sy: Array, interp: str, wrap: bool, xp=jnp) -> Array:
    """Dispatch on interpolation mode (reference src/reproject.cpp:348-368)."""
    try:
        fn = SAMPLERS[interp]
    except KeyError:
        raise ValueError(f"Interpolation method not supported: {interp!r}")
    return fn(src, sx, sy, wrap, xp=xp)
