"""Device mesh construction and sharding helpers.

Parallelism design (SURVEY.md §2.3, §5.7-5.8). The reference's only
scaling axis is image count on a CPU thread pool (src/main.cpp:536-660);
here the first-class axes are:

* ``batch`` — data parallelism: images of a batch spread across devices
  (the direct analog of the reference's per-image thread fan-out);
* ``rows``  — intra-image spatial parallelism: the *output pixel grid* of
  each image is split into horizontal bands across devices (the analog
  of sequence/context parallelism; the equirect wraparound is the
  ring-attention analog and is handled by gathering full source rows).

The mesh is a plain (batch, rows) reshape of the device list; it assumes
no interconnect topology. Collectives: one ``all_gather`` of source
row-bands along ``rows`` per step, nothing else — remapping is
gather-heavy but communication-light, so a 2-D mesh with XLA-inserted
collectives is the whole story; no custom transport is warranted.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
ROWS_AXIS = "rows"


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    batch: Optional[int] = None,
    rows: Optional[int] = None,
) -> Mesh:
    """Build a (batch, rows) mesh over the given (or all) devices.

    With no explicit split, favors the batch axis (throughput) and keeps
    rows = 1; pass ``rows > 1`` to enable intra-image sharding for
    huge-pano outputs.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if batch is None and rows is None:
        batch, rows = n, 1
    elif batch is None:
        batch = n // rows
    elif rows is None:
        rows = n // batch
    if batch * rows != n:
        raise ValueError(f"mesh {batch}x{rows} != {n} devices")
    arr = np.asarray(devices).reshape(batch, rows)
    return Mesh(arr, (BATCH_AXIS, ROWS_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W, C) images sharded over batch, replicated over rows."""
    return NamedSharding(mesh, P(BATCH_AXIS, None, None, None))


def input_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W, C) source sharded over batch AND rows (H split).

    Each device holds a row-band of its batch shard's source images; the
    remap step all-gathers the bands along ``rows`` (full source needed:
    lens remaps gather globally).
    """
    return NamedSharding(mesh, P(BATCH_AXIS, ROWS_AXIS, None, None))


def output_sharding(mesh: Mesh) -> NamedSharding:
    """(B, out_h, out_w, C) outputs sharded over batch and rows."""
    return NamedSharding(mesh, P(BATCH_AXIS, ROWS_AXIS, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
