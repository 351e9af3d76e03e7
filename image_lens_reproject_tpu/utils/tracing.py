"""Tracing / profiling zones — the analog of the reference's Tracy hooks.

Reference: Tracy ``ZoneScoped`` macros around decode / remap / tonemap /
encode (src/reproject.cpp:277,407,422; src/image_formats.cpp:145,209,306;
src/main.cpp:145,545 — SURVEY.md C20). Here zones are:

* ``jax.profiler.TraceAnnotation`` when a JAX profiler trace is active
  (viewable in Perfetto / TensorBoard via ``start_trace``), and
* wall-clock accumulators always, printed as a per-phase summary —
  the reference's Tracy zone timings, without needing the Tracy UI.

Enable a full device trace with ``LENSREPROJECT_TRACE_DIR=/path`` or the
CLI ``--trace-dir`` flag; per-phase timers are always on and reported by
``zone_report()``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Tuple

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_trace_active: Optional[str] = None


@contextlib.contextmanager
def trace_zone(name: str) -> Iterator[None]:
    """Time a named phase; nests into a JAX profiler trace when active."""
    ann = None
    try:
        import jax.profiler

        ann = jax.profiler.TraceAnnotation(name)
    except Exception:
        pass
    t0 = time.perf_counter()
    if ann is not None:
        ann.__enter__()
    try:
        yield
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def start_trace(trace_dir: str) -> None:
    """Start a jax profiler trace (Perfetto/TensorBoard-viewable)."""
    global _trace_active
    import jax.profiler

    jax.profiler.start_trace(trace_dir)
    _trace_active = trace_dir


def stop_trace() -> None:
    global _trace_active
    if _trace_active is not None:
        import jax.profiler

        jax.profiler.stop_trace()
        _trace_active = None


def zone_totals() -> Dict[str, Tuple[float, int]]:
    with _lock:
        return {k: (_totals[k], _counts[k]) for k in _totals}


def reset_zones() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


def zone_report() -> str:
    """Per-phase wall-time summary, the console analog of Tracy zones."""
    rows = zone_totals()
    if not rows:
        return ""
    lines = ["--- phase timings ---"]
    for name, (total, n) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{name:>20s}: {total*1e3:9.1f} ms total / {n:5d} calls")
    return "\n".join(lines)
