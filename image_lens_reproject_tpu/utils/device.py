"""The accelerator a measurement runs on, as the card and as JAX see it.

Measurement scripts name the card they ran on (``nvidia-smi`` name and
power limit, read before JAX touches the card) and JAX's view of it
(platform, device kind, count), and refuse to run without a GPU: a number
taken on the CPU is never reported as a device number.
"""

from __future__ import annotations

import subprocess

import jax

# Peak device-memory bandwidth by JAX device_kind, bytes/s.
# Source: NVIDIA H100 SXM data sheet (80 GB HBM3, 3.35 TB/s).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def require_gpu() -> list:
    """JAX's devices; raises RuntimeError unless they are GPUs."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {len(devices)} {devices[0].platform} device(s)"
        )
    return devices


def describe(devices) -> dict:
    """The device record every result carries."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    """Published memory bandwidth of a device kind; unknown kinds raise."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak bandwidth recorded for device kind {device_kind!r}"
        ) from None
