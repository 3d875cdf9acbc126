"""Channel-mode and stereo-model tests (SELECTCHANNEL / SELECTMODE parity).

Kept compile-light: 3-scale pipelines, var-ref exercised separately on a
single level (CPU jit of a full 4-scale var-ref pipeline takes minutes).
"""

import numpy as np
import jax
import jax.numpy as jnp

from flowonthego.config import DISConfig
from flowonthego.ops.channels import (prepare_input, to_grayscale,
                                      to_gradient_magnitude)
from flowonthego.ops.variational import variational_refine
from flowonthego.models.dis_flow import dis_flow_padded_jit
from flowonthego.models.stereo import stereo_disparity_padded


def _smooth(rng, h, w):
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(
        rng.standard_normal((h, w, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128


def test_grayscale_pipeline_recovers_translation(rng):
    h, w = 64, 96
    base = _smooth(rng, h + 16, w + 16)
    img0 = base[8:8 + h, 8:8 + w]
    img1 = base[6:6 + h, 5:5 + w]       # flow = (+3, +2)
    g0 = prepare_input(jnp.asarray(img0), "gray")
    g1 = prepare_input(jnp.asarray(img1), "gray")
    assert g0.shape == (h, w, 1)
    cfg = DISConfig(coarsest_scale=3, finest_scale=1, grad_descent_iter=12,
                    use_var_ref=False)
    flow = np.asarray(dis_flow_padded_jit(g0, g1, cfg)) * 2.0  # values at fs=1
    inner = flow[6:-6, 6:-6]
    np.testing.assert_allclose(np.median(inner[..., 0]), 3.0, atol=0.2)
    np.testing.assert_allclose(np.median(inner[..., 1]), 2.0, atol=0.2)


def test_varref_single_channel(rng):
    """Variational refinement is channel-generic (C=1 path)."""
    from scipy.ndimage import gaussian_filter
    h, w = 32, 40
    base = gaussian_filter(
        rng.standard_normal((h + 8, w + 8, 1)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    im1 = jnp.asarray(base[4:4 + h, 4:4 + w])
    im2 = jnp.asarray(base[4:4 + h, 3:3 + w])   # true flow u = +1
    true = np.zeros((h, w, 2), np.float32)
    true[..., 0] = 1.0
    noisy = true + 0.3 * rng.standard_normal((h, w, 2)).astype(np.float32)
    refined = np.asarray(jax.jit(variational_refine,
                                 static_argnames=("cfg", "level"))(
        jnp.asarray(noisy), im1, im2, DISConfig(), level=3))
    err_before = np.abs(noisy - true)[4:-4, 4:-4].mean()
    err_after = np.abs(refined - true)[4:-4, 4:-4].mean()
    assert err_after < 0.6 * err_before


def test_gradient_magnitude_mode_shapes(rng):
    img = jnp.asarray(_smooth(rng, 16, 16))
    gm = to_gradient_magnitude(img)
    assert gm.shape == (16, 16, 1)
    assert float(gm.min()) >= 0.0
    gray = to_grayscale(img)
    np.testing.assert_allclose(np.asarray(gray[..., 0]),
                               0.114 * np.asarray(img[..., 0])
                               + 0.587 * np.asarray(img[..., 1])
                               + 0.299 * np.asarray(img[..., 2]), rtol=1e-5)


def test_stereo_recovers_horizontal_disparity(rng):
    h, w = 48, 64
    base = _smooth(rng, h + 16, w + 16)
    left = jnp.asarray(base[8:8 + h, 8:8 + w])
    # right image shifted +3 px: matching left->right needs disparity -3
    right = jnp.asarray(base[8:8 + h, 11:11 + w])
    cfg = DISConfig(coarsest_scale=2, finest_scale=0, grad_descent_iter=12,
                    use_var_ref=False)
    disp = np.asarray(jax.jit(stereo_disparity_padded,
                              static_argnames=("cfg", "cam_lr"))(
        left, right, cfg, cam_lr=0))
    med = np.median(disp[8:-8, 8:-8])
    np.testing.assert_allclose(med, -3.0, atol=0.1)
    # sign clamp: disparity never positive for cam_lr=0
    assert disp.max() <= 1e-6
