"""Pure projection math: pixel coordinate <-> light ray, per lens model.

Re-design of the reference's per-pixel function-pointer pairs
``target_to_vec_t`` / ``vec_to_source_t`` (reference src/reproject.cpp:24-29,
150-271). Here every function is a *vectorized* pure jnp map over whole
coordinate fields — dense elementwise math that XLA fuses into the remap
kernel — instead of a scalar callback invoked per pixel.

Coordinate convention (reference src/reproject.cpp:10-13): pixel centers,
image centered at (0, 0), corners at (±0.5*w, ±0.5*h). The camera looks
down -z for rectilinear; the reference's equidistant forward map produces
+cos(theta) for z (src/reproject.cpp:185) — geometrically inconsistent with
rectilinear's z=-1, but replicated verbatim here because exact-formula
parity with the reference is a hard requirement (outputs must match to
<1e-3); see SURVEY.md §2.1.

All functions operate on (and return) float32 arrays of any shape and are
trace-compatible with both jnp and numpy (the ``xp`` argument), so the same
formulas serve the jitted device path and the float32 numpy oracle used in
golden tests.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp

from .lens import (
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    Rectilinear,
)

Array = Any


def _f32(xp, v: float):
    return xp.float32(v)


# === RECTILINEAR (reference src/reproject.cpp:152-167) ===


def rectilinear_to_vec(
    lens: Rectilinear, img_w: float, img_h: float, cx: Array, cy: Array, xp=jnp
) -> Tuple[Array, Array, Array]:
    """Pixel -> ray. x = cx/w * sensor_w/f, y likewise, z = -1."""
    fx = _f32(xp, lens.sensor_width / (img_w * lens.focal_length))
    fy = _f32(xp, lens.sensor_height / (img_h * lens.focal_length))
    x = cx * fx
    y = cy * fy
    z = xp.full_like(x, _f32(xp, -1.0))
    return x, y, z


def vec_to_rectilinear(
    lens: Rectilinear, img_w: float, img_h: float, x: Array, y: Array, z: Array, xp=jnp
) -> Tuple[Array, Array]:
    """Ray -> pixel: perspective divide by -z, scale to pixels."""
    xn = x / -z
    yn = y / -z
    gx = _f32(xp, img_w * lens.focal_length / lens.sensor_width)
    gy = _f32(xp, img_h * lens.focal_length / lens.sensor_height)
    return xn * gx, yn * gy


# === FISHEYE EQUIDISTANT (reference src/reproject.cpp:171-206) ===


def equidistant_to_vec(
    lens: FisheyeEquidistant, img_w: float, img_h: float, cx: Array, cy: Array, xp=jnp
) -> Tuple[Array, Array, Array]:
    """Pixel -> ray: theta = r_mm / f with f = sensor_w / fov.

    Note z = +cos(theta) as in the reference (src/reproject.cpp:185).
    The reference divides sin(theta) by r_px without guarding r_px == 0
    (NaN at an exactly-centered pixel); we guard with a where() since a
    NaN would poison the gather — the guarded value only triggers on the
    measure-zero exact center, where sin(theta)/r_px -> theta/r_px ~ fov/w.
    """
    r_px = xp.sqrt(cx * cx + cy * cy)
    # theta = (r_px / img_w * sensor_w) / (sensor_w / fov) = r_px * fov / img_w
    theta = r_px * _f32(xp, lens.fov / img_w)
    safe_r = xp.where(r_px > 0, r_px, _f32(xp, 1.0))
    s = xp.where(r_px > 0, xp.sin(theta) / safe_r, _f32(xp, lens.fov / img_w))
    x = s * cx
    y = s * cy
    z = xp.cos(theta)
    return x, y, z


def vec_to_equidistant(
    lens: FisheyeEquidistant, img_w: float, img_h: float, x: Array, y: Array, z: Array, xp=jnp
) -> Tuple[Array, Array]:
    """Ray -> pixel via perspective divide then theta = atan(r).

    Replicates the reference's formula (src/reproject.cpp:188-206)
    including its behind-camera limitation: the /(-z) divide + atan makes
    the map valid only for rays with z < 0 after rotation (theta < 90°);
    content behind the camera mirrors, exactly as the reference does.
    """
    xn = x / -z
    yn = y / -z
    r = xp.sqrt(xn * xn + yn * yn)
    theta = xp.arctan(r)
    # r_px = f * theta / sensor_w * img_w = theta * img_w / fov
    r_px = theta * _f32(xp, img_w / lens.fov)
    safe_r = xp.where(r > 0, r, _f32(xp, 1.0))
    scale = xp.where(r > 0, r_px / safe_r, _f32(xp, img_w / lens.fov))
    return xn * scale, yn * scale


# === FISHEYE EQUISOLID (gap-fill; Blender model, no reference math) ===
#
# The reference parses equisolid lenses but aborts on projecting them
# (src/reproject.cpp:395-398, 415-418). We implement the Blender camera
# model r_mm = 2 f sin(theta/2), styled consistently with the reference's
# equidistant pair: forward emits z=+cos(theta), inverse perspective-divides
# by -z then theta = atan(r).


def equisolid_to_vec(
    lens: FisheyeEquisolid, img_w: float, img_h: float, cx: Array, cy: Array, xp=jnp
) -> Tuple[Array, Array, Array]:
    """Pixel -> ray: theta = 2 asin(r_mm / (2 f)).

    r_mm beyond the lens' physical radius 2f would produce NaN from asin;
    clamp the asin argument to [-1, 1] (corner pixels outside the image
    circle map to the outermost ring, mirroring how clamping samplers
    treat out-of-bounds coordinates).
    """
    r_px = xp.sqrt(cx * cx + cy * cy)
    r_mm = r_px * _f32(xp, lens.sensor_width / img_w)
    a = r_mm * _f32(xp, 1.0 / (2.0 * lens.focal_length))
    a = xp.clip(a, _f32(xp, -1.0), _f32(xp, 1.0))
    theta = _f32(xp, 2.0) * xp.arcsin(a)
    safe_r = xp.where(r_px > 0, r_px, _f32(xp, 1.0))
    # lim_{r->0} sin(theta)/r_px = dtheta/dr_px = sensor_w / (f * img_w)
    center_slope = _f32(xp, lens.sensor_width / (lens.focal_length * img_w))
    s = xp.where(r_px > 0, xp.sin(theta) / safe_r, center_slope)
    x = s * cx
    y = s * cy
    z = xp.cos(theta)
    return x, y, z


def vec_to_equisolid(
    lens: FisheyeEquisolid, img_w: float, img_h: float, x: Array, y: Array, z: Array, xp=jnp
) -> Tuple[Array, Array]:
    """Ray -> pixel: theta = atan(r) after perspective divide, r_mm = 2 f sin(theta/2)."""
    xn = x / -z
    yn = y / -z
    r = xp.sqrt(xn * xn + yn * yn)
    theta = xp.arctan(r)
    r_mm = _f32(xp, 2.0 * lens.focal_length) * xp.sin(_f32(xp, 0.5) * theta)
    r_px = r_mm * _f32(xp, img_w / lens.sensor_width)
    safe_r = xp.where(r > 0, r, _f32(xp, 1.0))
    center_slope = _f32(xp, lens.focal_length * img_w / lens.sensor_width)
    scale = xp.where(r > 0, r_px / safe_r, center_slope)
    return xn * scale, yn * scale


# === FISHEYE STEREOGRAPHIC (gap-fill; r_mm = 2 f tan(theta/2)) ===
#
# Enum-only in the reference (src/config.hpp:11, no math anywhere); the
# standard stereographic model, styled like the other fisheye pairs
# (forward z=+cos(theta), inverse perspective-divide + atan).


def stereographic_to_vec(
    lens: FisheyeStereographic, img_w: float, img_h: float, cx: Array, cy: Array, xp=jnp
) -> Tuple[Array, Array, Array]:
    """Pixel -> ray: theta = 2 atan(r_mm / (2 f))."""
    r_px = xp.sqrt(cx * cx + cy * cy)
    r_mm = r_px * _f32(xp, lens.sensor_width / img_w)
    theta = _f32(xp, 2.0) * xp.arctan(r_mm * _f32(xp, 1.0 / (2.0 * lens.focal_length)))
    safe_r = xp.where(r_px > 0, r_px, _f32(xp, 1.0))
    center_slope = _f32(xp, lens.sensor_width / (lens.focal_length * img_w))
    s = xp.where(r_px > 0, xp.sin(theta) / safe_r, center_slope)
    x = s * cx
    y = s * cy
    z = xp.cos(theta)
    return x, y, z


def vec_to_stereographic(
    lens: FisheyeStereographic, img_w: float, img_h: float, x: Array, y: Array, z: Array, xp=jnp
) -> Tuple[Array, Array]:
    """Ray -> pixel: theta = atan(r) after perspective divide, r_mm = 2 f tan(theta/2)."""
    xn = x / -z
    yn = y / -z
    r = xp.sqrt(xn * xn + yn * yn)
    theta = xp.arctan(r)
    r_mm = _f32(xp, 2.0 * lens.focal_length) * xp.tan(_f32(xp, 0.5) * theta)
    r_px = r_mm * _f32(xp, img_w / lens.sensor_width)
    safe_r = xp.where(r > 0, r, _f32(xp, 1.0))
    center_slope = _f32(xp, lens.focal_length * img_w / lens.sensor_width)
    scale = xp.where(r > 0, r_px / safe_r, center_slope)
    return xn * scale, yn * scale


# === EQUIRECTANGULAR (reference src/reproject.cpp:245-271) ===


def equirectangular_to_vec(
    lens: Equirectangular, img_w: float, img_h: float, cx: Array, cy: Array, xp=jnp
) -> Tuple[Array, Array, Array]:
    """Pixel -> ray.

    NOTE: the reference's forward map (src/reproject.cpp:254-256) omits the
    geometrically standard cos(latitude) scaling of the horizontal
    components — the ray is NOT a unit vector. Replicated verbatim: its
    inverse partner compensates via asin(y/|v|), and output parity with the
    reference requires the same non-normalization.
    """
    lon_span = lens.longitude_span
    lat_span = lens.latitude_span
    lon = (cx * _f32(xp, 1.0 / img_w) + _f32(xp, 0.5)) * _f32(xp, lon_span) + _f32(
        xp, lens.longitude_min
    )
    lat = (cy * _f32(xp, 1.0 / img_h) + _f32(xp, 0.5)) * _f32(xp, lat_span) + _f32(
        xp, lens.latitude_min
    )
    x = xp.sin(lon)
    z = -xp.cos(lon)
    y = xp.sin(lat)
    return x, y, z


def vec_to_equirectangular(
    lens: Equirectangular, img_w: float, img_h: float, x: Array, y: Array, z: Array, xp=jnp
) -> Tuple[Array, Array]:
    """Ray -> pixel: theta = -atan2(-x, -z), phi = asin(y / |v|)."""
    theta = -xp.arctan2(-x, -z)
    phi = xp.arcsin(y / xp.sqrt(x * x + y * y + z * z))
    lon_span = lens.longitude_span
    lat_span = lens.latitude_span
    cx = ((theta - _f32(xp, lens.longitude_min)) * _f32(xp, 1.0 / lon_span) - _f32(xp, 0.5)) * _f32(
        xp, img_w
    )
    cy = ((phi - _f32(xp, lens.latitude_min)) * _f32(xp, 1.0 / lat_span) - _f32(xp, 0.5)) * _f32(
        xp, img_h
    )
    return cx, cy


# === dispatch tables ===

_TO_VEC = {
    Rectilinear: rectilinear_to_vec,
    FisheyeEquidistant: equidistant_to_vec,
    FisheyeEquisolid: equisolid_to_vec,
    FisheyeStereographic: stereographic_to_vec,
    Equirectangular: equirectangular_to_vec,
}

_TO_SOURCE = {
    Rectilinear: vec_to_rectilinear,
    FisheyeEquidistant: vec_to_equidistant,
    FisheyeEquisolid: vec_to_equisolid,
    FisheyeStereographic: vec_to_stereographic,
    Equirectangular: vec_to_equirectangular,
}


def target_to_vec(
    lens: LensSpec, img_w: float, img_h: float, cx: Array, cy: Array, xp=jnp
) -> Tuple[Array, Array, Array]:
    """Dispatch on output-lens type (reference src/reproject.cpp:405-419)."""
    try:
        fn = _TO_VEC[type(lens)]
    except KeyError:
        raise ValueError(f"Output lens type not supported: {type(lens).__name__}")
    return fn(lens, img_w, img_h, cx, cy, xp=xp)


def vec_to_source(
    lens: LensSpec, img_w: float, img_h: float, x: Array, y: Array, z: Array, xp=jnp
) -> Tuple[Array, Array]:
    """Dispatch on input-lens type (reference src/reproject.cpp:375-399)."""
    try:
        fn = _TO_SOURCE[type(lens)]
    except KeyError:
        raise ValueError(f"Input lens type not supported: {type(lens).__name__}")
    return fn(lens, img_w, img_h, x, y, z, xp=xp)
