"""Multi-host initialization and mesh construction.

SURVEY.md §5.8: the reference has no distributed backend (single process);
the equivalent here is ``jax.distributed.initialize`` + a global mesh
whose collectives XLA inserts across every process's devices. This module
is the one-call entry point for multi-process runs:

    from image_lens_reproject_tpu.parallel import distributed
    distributed.init("host0:1234", num_processes=2, process_id=0)
    mesh = distributed.global_mesh(rows=2)

The remap workload needs only the batch/rows axes (all_gather of source
row-bands along ``rows``); process-spanning batch entries shard across
hosts automatically through jax.Array's global sharding.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from .mesh import make_mesh

_initialized = False


def init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process; else no-op.

    Initializes when a coordinator is given, either as an argument or
    through ``JAX_COORDINATOR_ADDRESS`` (set ``ILR_DISTRIBUTED=0`` to opt
    out of the latter). A failed ``jax.distributed.initialize`` raises
    with its own message. Returns True if distributed mode is active.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    from_env = "JAX_COORDINATOR_ADDRESS" in os.environ
    if coordinator_address is not None or (
        from_env and os.environ.get("ILR_DISTRIBUTED", "1") != "0"
    ):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    return jax.process_count() > 1


def global_mesh(batch: Optional[int] = None, rows: Optional[int] = None):
    """Mesh over ALL devices (every process's); see mesh.make_mesh."""
    return make_mesh(devices=jax.devices(), batch=batch, rows=rows)


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a globally-sharded batch dimension."""
    per = global_batch // max(jax.process_count(), 1)
    start = jax.process_index() * per
    return slice(start, start + per)
