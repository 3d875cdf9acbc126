"""Profiling hooks — equivalent of the reference's verbosity-gated
per-phase timing (src/common/timer.h + the oflow.cpp TIME lines).

Two mechanisms:
  * :func:`trace` — jax.profiler trace context writing a TensorBoard-
    compatible trace (device timeline, per-HLO costs).
  * :func:`annotate` — named ranges (jax.profiler.TraceAnnotation) that
    show up inside traces, the analogue of the reference's phase names
    (pconst/pinit/poptim/cflow/tvopt).
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/fot_trace", create_perfetto_link: bool = False):
    """Capture a device trace: ``with trace("/tmp/t"): run()``.

    View with TensorBoard's profile plugin or Perfetto.
    """
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named range for trace timelines (phase-timer analogue)."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> dict:
    """Per-device memory stats (bytes in use / limit) when available."""
    stats = {}
    for d in jax.devices():
        try:
            ms = d.memory_stats()
        except Exception:
            ms = None
        if ms:
            stats[str(d)] = {
                "bytes_in_use": ms.get("bytes_in_use"),
                "peak_bytes_in_use": ms.get("peak_bytes_in_use"),
                "bytes_limit": ms.get("bytes_limit"),
            }
    return stats
