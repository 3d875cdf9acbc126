"""Verbosity-2 diagnostic path (compute_flow_timed): reference-format
per-scale timing lines + identical flow output.

Matches src/oflow.cpp:346 ('TIME (Sc: ...)') and
src/patchgrid.cpp:334-345 (printTimings aggregates).
"""

import numpy as np
import pytest

from flowonthego.config import DISConfig
from flowonthego.models.dis_flow import compute_flow, compute_flow_timed


def _smooth_pair(rng, h, w):
    from scipy.ndimage import gaussian_filter
    I0 = gaussian_filter(rng.standard_normal((h, w, 3)).astype(np.float32),
                         (3, 3, 0)) * 120 + 128
    return I0, np.roll(I0, 2, axis=1)


@pytest.mark.slow    # the timed path is exercised at CLI verbosity 2;
# the numerical-equality regression runs in the slow suite
def test_timed_output_matches_fast_path(rng):
    I0, I1 = _smooth_pair(rng, 48, 64)
    cfg = DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=4,
                    use_var_ref=True)
    lines = []
    fast = np.asarray(compute_flow(I0, I1, cfg=cfg))
    timed = np.asarray(compute_flow_timed(I0, I1, cfg=cfg,
                                          printer=lines.append))
    # eager phase-by-phase vs one fused jit: fp-order differences only
    np.testing.assert_allclose(timed, fast, rtol=1e-3, atol=1e-3)

    text = "\n".join(lines)
    assert "TIME (Pyramide+Gradients) (ms):" in text
    # one canonical per-scale line per processed scale, reference format
    sc_lines = [ln for ln in lines if ln.startswith("TIME (Sc:")]
    assert len(sc_lines) == cfg.n_scales
    for ln in sc_lines:
        assert "pconst, pinit, poptim, cflow, tvopt, total" in ln
    assert "TIME (O.Flow Run-Time   ) (ms):" in text
    # printTimings-style aggregate block
    assert "Timings (ms)" in text and "opti" in text and "aggregate" in text
