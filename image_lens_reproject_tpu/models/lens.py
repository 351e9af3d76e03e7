"""Lens model specifications.

Re-design of the reference's ``LensInfo`` tagged union
(reference: src/config.hpp:7-37). Instead of a C union we use frozen
dataclasses that are hashable so they can ride along as *static* arguments
to ``jax.jit`` — every (in_lens_type, out_lens_type, interpolation, wrap)
combination compiles to its own fused XLA program, replacing the
reference's 36 C++ template instantiations (src/reproject.cpp:348-419).

All angles are radians, all physical lengths are millimetres, mirroring
the reference conventions (src/config.cpp:7-56, src/main.cpp:15-95).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Union


class LensType(enum.Enum):
    """Mirror of reference LensType (src/config.hpp:7-13)."""

    RECTILINEAR = "RECTILINEAR"
    FISHEYE_EQUIDISTANT = "FISHEYE_EQUIDISTANT"
    FISHEYE_EQUISOLID = "FISHEYE_EQUISOLID"
    FISHEYE_STEREOGRAPHIC = "FISHEYE_STEREOGRAPHIC"
    EQUIRECTANGULAR = "EQUIRECTANGULAR"


@dataclasses.dataclass(frozen=True)
class Rectilinear:
    """Pinhole lens (reference src/config.hpp:18-20).

    focal_length, sensor_width/height in mm.
    """

    focal_length: float
    sensor_width: float
    sensor_height: float

    type = LensType.RECTILINEAR


@dataclasses.dataclass(frozen=True)
class FisheyeEquidistant:
    """Equidistant fisheye, r_mm = f * theta (reference src/config.hpp:21-23).

    ``fov`` in radians. The effective focal length is derived as
    ``sensor_width / fov`` (reference src/reproject.cpp:178).
    """

    fov: float
    sensor_width: float
    sensor_height: float

    type = LensType.FISHEYE_EQUIDISTANT


@dataclasses.dataclass(frozen=True)
class FisheyeEquisolid:
    """Equisolid fisheye, r_mm = 2 f sin(theta/2) (Blender camera model).

    The reference parses this lens (src/main.cpp:31-47, src/config.cpp:23-27)
    but has NO projection math for it — using it aborts with
    "lens type not supported" (src/reproject.cpp:395-398, 415-418).
    This framework implements the real Blender model, closing that gap.

    ``fov`` (radians) is carried for config round-trip parity but does not
    enter the projection equations (as in Blender, it only clips the circle).
    """

    focal_length: float
    fov: float
    sensor_width: float
    sensor_height: float

    type = LensType.FISHEYE_EQUISOLID


@dataclasses.dataclass(frozen=True)
class FisheyeStereographic:
    """Stereographic fisheye, r_mm = 2 f tan(theta/2).

    The reference declares FISHEYE_STEREOGRAPHIC in its enum
    (src/config.hpp:11) but has no parser, no JSON mapping and no math —
    it is enum-only. This framework implements the standard stereographic
    model as a gap-fill extension (CLI: --i-stereographic/--stereographic,
    JSON panorama_type "FISHEYE_STEREOGRAPHIC").
    """

    focal_length: float
    fov: float
    sensor_width: float
    sensor_height: float

    type = LensType.FISHEYE_STEREOGRAPHIC


@dataclasses.dataclass(frozen=True)
class Equirectangular:
    """Equirectangular panorama segment (reference src/config.hpp:28-33).

    Longitude/latitude bounds in radians. sensor size is meaningless for
    this lens; the reference stores 0 (src/main.cpp:93).
    """

    longitude_min: float
    longitude_max: float
    latitude_min: float
    latitude_max: float
    sensor_width: float = 0.0
    sensor_height: float = 0.0

    type = LensType.EQUIRECTANGULAR

    @property
    def longitude_span(self) -> float:
        return self.longitude_max - self.longitude_min

    @property
    def latitude_span(self) -> float:
        return self.latitude_max - self.latitude_min

    def is_full_360(self, tol: float = 1e-5) -> bool:
        """Whether the horizontal span covers the full circle.

        Mirrors the wraparound-dispatch predicate of the reference
        (src/reproject.cpp:386-394): ``|span - 2*pi| < 1e-5``.
        When true, horizontal sampling wraps modulo width instead of
        clamping.
        """
        return abs(self.longitude_span - 2.0 * math.pi) < tol


LensSpec = Union[
    Rectilinear,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    Equirectangular,
]


def full_equirectangular() -> Equirectangular:
    """The 'full' equirect pano of reference src/main.cpp:62-66."""
    return Equirectangular(
        longitude_min=-math.pi,
        longitude_max=math.pi,
        latitude_min=-math.pi * 0.5,
        latitude_max=math.pi * 0.5,
    )


def wrap_mode_for_input(lens: LensSpec) -> bool:
    """True if sampling from this input lens should wrap horizontally.

    Reference: src/reproject.cpp:384-394 — wrap is enabled only for a
    full-360 equirectangular *input* image.
    """
    return isinstance(lens, Equirectangular) and lens.is_full_360()
