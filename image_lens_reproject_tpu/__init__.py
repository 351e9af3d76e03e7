"""image_lens_reproject_tpu — a JAX lens reprojection framework.

A from-scratch JAX/XLA rebuild of the capabilities of
IDLabMedia/image-lens-reproject (C++17 CPU CLI): reproject images between
rectilinear, equidistant-fisheye, equisolid-fisheye and equirectangular
lens models, with rotation, supersampling, NN/bilinear/bicubic
interpolation, exposure + extended-Reinhard tonemapping, EXR/PNG/JPEG I/O,
Blender-style JSON configs, and batch directory processing — redesigned as
fused, jit-compiled device programs over sharded image batches instead of
a scalar per-pixel CPU loop.

Layout:
    models/    lens specs + pixel<->ray projection math + rotation
    ops/       remap core, samplers, color ops, fused remap+tonemap
    parallel/  mesh / sharding / multi-device batch dispatch
    utils/     oracle, config JSON, misc host utilities
    io/        EXR / PNG / JPEG codecs (host side)
    pipeline   batch orchestrator (discovery, prefetch, device dispatch)
    cli        argparse CLI mirroring every reference flag
"""

from .models.lens import (
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    LensType,
    Rectilinear,
    full_equirectangular,
)
from .models.rotation import rotation_matrix, rotation_matrix_degrees
from .ops.color import post_process, post_process_jit
from .ops.remap import remap_batch_jit, remap_image, remap_jit
from .ops.remap_fused import remap_tonemap

__version__ = "0.1.0"

__all__ = [
    "Equirectangular",
    "FisheyeEquidistant",
    "FisheyeEquisolid",
    "FisheyeStereographic",
    "LensSpec",
    "LensType",
    "Rectilinear",
    "full_equirectangular",
    "rotation_matrix",
    "rotation_matrix_degrees",
    "post_process",
    "post_process_jit",
    "remap_batch_jit",
    "remap_image",
    "remap_jit",
    "remap_tonemap",
]
