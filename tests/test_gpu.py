"""Checks that need the card: the compiled GN kernel against the XLA
loop at real widths, and the GPU pipeline against the CPU backend.
Skipped elsewhere (the ``gpu`` fixture decides); run on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""

import pytest

from flowonthego import checks

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("op,h,w", [(2, 436, 1024), (4, 436, 1024)])
def test_gn_kernel_matches_xla_loop(gpu, op, h, w):
    assert checks.gn_kernel_vs_xla(op, h, w)


def test_flow_matches_cpu_backend(gpu):
    checks.flow_gpu_vs_cpu(2, 436, 1024)
