"""The accelerator a measurement runs on, named the same way everywhere."""

from __future__ import annotations

import subprocess


def card() -> str:
    """The cards' names and power limits, as nvidia-smi reports them
    (one card per ``; ``-separated entry)."""
    try:
        return "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.split("\n")).strip("; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def require_gpu(count: int = 1):
    """JAX's devices, after checking that they are ``count`` or more GPUs;
    raises SystemExit otherwise (a measurement never falls back to the
    CPU)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0]} "
                         f"({devs[0].platform})")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, found {len(devs)}")
    return devs
