"""Test configuration: CPU with 8 virtual devices unless told otherwise.

The sharded paths are exercised on a fake 8-device mesh (XLA
--xla_force_host_platform_device_count), per SURVEY.md §4 — distributed
logic is tested without a cluster.  Both settings are read when JAX
initialises its first backend, which happens after this file runs.
Tests marked ``gpu`` decide inside a fixture whether a GPU is present
(run them on the card with ``JAX_PLATFORMS=cuda,cpu``).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Silence XLA:CPU's AOT-load chatter BEFORE anything compiles:
# deserializing even *same-machine* cache entries prints a full
# machine-feature dump at ERROR severity (the compile feature list always
# contains pseudo-features like +prefer-no-scatter that no host cpuid
# has).  We filter the exact noise lines at the fd level instead
# (utils/logfilter.py); real errors still reach the terminal.
from flowonthego.utils.logfilter import \
    install_stderr_noise_filter  # noqa: E402

install_stderr_noise_filter()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Persistent compilation cache (utils/cache.py): the suite is
# compile-bound (every test jits real pipelines).
from flowonthego.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture(scope="session")
def sintel_pair():
    """A generated frame pair at Sintel geometry (1024x436, BGR float32
    0..255) with known ground-truth flow — see :func:`reference_flow`."""
    from flowonthego.utils import synth
    I0, I1, _ = synth.pair(436, 1024, seed=0)
    return I0, I1


@pytest.fixture(scope="session")
def reference_flow():
    """Ground-truth forward flow of :func:`sintel_pair`."""
    from flowonthego.utils import synth
    return synth.pair(436, 1024, seed=0)[2]


@pytest.fixture()
def gpu():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first JAX device is {dev.platform})")
    return dev


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
