"""Headline throughput: 4K equirect -> rectilinear remap on one GPU (Mpix/s).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "Mpix/s", "device": {...}, ...}

The headline config (BASELINE.json): full-360 equirectangular 3840x1920
source -> 3840x2160 rectilinear output, bicubic interpolation with fused
exposure + extended-Reinhard tonemap, float32, through
``remap_fused.remap_tonemap``. Every iteration is data-dependent on the
previous one (a scalar derived from the last output perturbs the next
input), and each timed repetition ends with ``block_until_ready``.

Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

SRC_H, SRC_W = 1920, 3840
OUT_H, OUT_W = 2160, 3840
INTERP = "bicubic"
REPS = 10  # the first rep is warm-up; the value is the median of the rest
ITERS_PER_REP = 50


def main() -> int:
    from image_lens_reproject_tpu.utils import compile_cache, device

    gpu = device.nvidia_smi()
    import jax
    import jax.numpy as jnp

    devices = device.require_gpu()
    compile_cache.enable()

    from image_lens_reproject_tpu.models.lens import Rectilinear, full_equirectangular
    from image_lens_reproject_tpu.models.rotation import rotation_matrix_degrees
    from image_lens_reproject_tpu.ops import remap_fused

    in_lens = full_equirectangular()
    out_lens = Rectilinear(35.0, 36.0, 36.0 * OUT_H / OUT_W)

    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.uniform(0, 2, size=(SRC_H, SRC_W, 3)).astype(np.float32))
    rot = jnp.asarray(rotation_matrix_degrees(20.0, 5.0, 0.0))

    @jax.jit
    def chain(src_, seed):
        # Perturb the input with a value derived from the previous output:
        # forces a true serial dependency across iterations.
        return remap_fused.remap_tonemap(
            src_ + seed * jnp.float32(1e-12),
            rot,
            in_lens=in_lens,
            out_lens=out_lens,
            out_h=OUT_H,
            out_w=OUT_W,
            interp=INTERP,
            n_samples=1,
            exposure=2.0,
            reinhard=4.0,
        )

    rates = []
    for _ in range(REPS):
        seed = jnp.float32(0.0)
        t0 = time.perf_counter()
        for _ in range(ITERS_PER_REP):
            out = chain(src, seed)
            seed = out[0, 0, 0]
        out.block_until_ready()
        dt = time.perf_counter() - t0
        rates.append(OUT_H * OUT_W * ITERS_PER_REP / dt / 1e6)

    print(json.dumps({
        "metric": "4K equirect->rectilinear bicubic+tonemap remap throughput",
        "value": float(np.median(rates[1:])),
        "unit": "Mpix/s",
        "device": device.describe(devices),
        "gpu": gpu,
        "out_resolution": [OUT_W, OUT_H],
        "interp": INTERP,
        "iters_per_rep": ITERS_PER_REP,
        "reps_mpix_s": rates,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
