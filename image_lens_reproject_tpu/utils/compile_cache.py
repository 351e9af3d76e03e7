"""Where JAX keeps its persistent compilation cache.

When ``JAX_COMPILATION_CACHE_DIR`` is in the environment, JAX reads it
itself and nothing here overrides it (an empty value turns the cache
off). Otherwise the cache goes to a fixed ``.jax_cache/`` directory at
the repository root: the path is part of what makes a later process find
an earlier one's programs, so it never depends on a pid, a time or a
temporary directory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> Optional[str]:
    """Point JAX's compilation cache at its directory; returns the path."""
    if ENV_VAR not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return jax.config.jax_compilation_cache_dir
