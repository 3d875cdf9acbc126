"""CPU rehearsal of chip_smoke.py: its generated ground truth is
consistent with its frames, and it refuses to report a result without a
GPU or without the rest of the repository."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from flowonthego.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("t", [0, 3])
def test_generated_flow_explains_the_next_frame(t):
    """Warping frame t+1 by the ground-truth flow of pair (t, t+1) gives
    back frame t up to bilinear resampling of the texture; the zero flow
    does not."""
    from scipy.ndimage import map_coordinates
    h, w = 96, 160
    f0 = np.asarray(synth.frame(t, h, w, seed=3))
    f1 = np.asarray(synth.frame(t + 1, h, w, seed=3))
    gt = np.asarray(synth.flow(t, h, w, seed=3))
    assert np.abs(gt).max() <= 5.0 + 1e-3 and np.abs(gt).mean() > 0.5
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    back = np.stack([map_coordinates(f1[..., c], [yy + gt[..., 1],
                                                  xx + gt[..., 0]], order=1,
                                     mode="nearest") for c in range(3)], -1)
    inner = (slice(8, -8), slice(8, -8))
    err_gt = np.abs(back - f0)[inner].mean()
    err_zero = np.abs(f1 - f0)[inner].mean()
    assert err_gt < 0.15 * err_zero, (err_gt, err_zero)


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _last_line(out: str) -> str:
    lines = out.strip().splitlines()
    return lines[-1] if lines else ""


def test_refuses_the_cpu():
    p = _run(REPO)
    assert p.returncode != 0
    assert '"ok"' not in _last_line(p.stdout)
    assert "no GPU" in p.stderr


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in _last_line(p.stdout)
