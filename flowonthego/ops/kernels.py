"""Which form runs the one stage that has a hand-written kernel.

The Gauss-Newton patch solve (ops/dis.py) has two forms: the plain XLA
loop and the persistent Pallas kernel (ops/pallas/dis_gn.py, Triton
route).  The choice is made here, from the configuration alone — never
from the process's default backend:

* ``cfg.gn_backend == "xla"``: the XLA loop everywhere.
* ``"pallas"``: the kernel everywhere; lowering it for a platform Triton
  cannot compile for (the CPU) fails loudly.
* ``"auto"`` (default): decided per lowering by
  ``jax.lax.platform_dependent`` — a program compiled for a CUDA device
  runs the kernel, a program compiled for any other platform runs the
  XLA loop.  One process can hold both (``chip_smoke.py`` compares its
  GPU flow with a CPU one).

Nothing falls back to the Pallas interpreter: tests that run the kernel
on the CPU ask for ``interpret=True`` themselves.  Semantics the
reduction form cannot express (``res_thresh > 0``, non-l2 costs, the
dp/dr early exit) take the reference loop on every backend.
"""

from __future__ import annotations

import jax

from ..config import DISConfig


def gn_route(cfg: DISConfig) -> str:
    """"reference", "xla", "pallas" or "auto" for ``cfg``'s GN solve."""
    if (cfg.res_thresh > 0.0 or cfg.cost_fn != "l2"
            or (cfg.min_iter is not None
                and cfg.min_iter < cfg.grad_descent_iter)):
        # non-quadratic costs transform the residual before projection
        # (the linear-reduction shortcut only holds for plain L2), and the
        # dp/dr early-exit clauses need the materialized residual too
        return "reference"
    return cfg.gn_backend


def dispatch(route: str, kernel_fn, xla_fn, *args):
    """Call ``kernel_fn(*args)`` or ``xla_fn(*args)`` as ``route`` says."""
    if route == "pallas":
        return kernel_fn(*args)
    if route == "xla":
        return xla_fn(*args)
    return jax.lax.platform_dependent(*args, cuda=kernel_fn, default=xla_fn)
