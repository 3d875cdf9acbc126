"""Wall-clock phase timers + compile warmup.

Equivalent of the reference's timer helpers (src/common/timer.h:27-41)
and its GPU warmup kernel (src/kernels/warmup.cpp:34-108).  JAX dispatch
is asynchronous, so a phase ends when its outputs are ready on the
device (``jax.block_until_ready``), the analogue of
``cudaDeviceSynchronize``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax
import jax.numpy as jnp


class PhaseTimer:
    """Accumulating named phase timer; ``report()`` mirrors the
    ``printTimings`` layout (src/patchgrid.cpp:334-345)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase.  The body appends the arrays it produces to the
        yielded list; the phase ends when all of them are ready."""
        outputs = []
        start = time.perf_counter()
        yield outputs
        jax.block_until_ready(outputs)
        self.totals[name] += (time.perf_counter() - start) * 1000.0
        self.counts[name] += 1

    def report(self) -> str:
        lines = ["=============== Timings (ms) ==============="]
        for name, total in self.totals.items():
            lines.append(f"[{name:<12}] {total:10.3f}  (n={self.counts[name]})")
        lines.append("============================================")
        return "\n".join(lines)


def warmup(device=None) -> None:
    """Absorb device-init cost before timing (cu::warmup analogue)."""
    x = jnp.ones((8, 128), jnp.float32)
    jax.block_until_ready(jnp.dot(x, x.T))


def time_fn(fn, *args, iters: int = 10, warmup_iters: int = 2) -> float:
    """Median wall time (ms) of ``fn(*args)`` with block_until_ready."""
    for _ in range(warmup_iters):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]
