"""Inverse-search optimizer behavior tests (semantics of optimize.cu)."""

import numpy as np
import jax.numpy as jnp

from flowonthego.config import DISConfig


def _jit_optimize(state, I1, grid, cfg):
    """One compiled program per scale-solve instead of eager op-by-op
    dispatch (each eager op is too small for the persistent compile
    cache; the jitted form is cached across processes)."""
    import jax
    return jax.jit(lambda st, im: dis_mod.optimize(st, im, grid, cfg))(
        state, I1)

from flowonthego.ops import dis as dis_mod
from flowonthego.ops.densify import densify
from flowonthego.ops.patches import PatchGrid, extract_templates_and_hessians
from flowonthego.ops.pyramid import pad_replicate, pad_constant, central_diff


def _setup(img0, img1, cfg):
    h, w = img0.shape[:2]
    grid = PatchGrid.create(cfg, w, h)
    gx0, gy0 = central_diff(jnp.asarray(img0))
    pad = cfg.padding
    I0 = pad_replicate(jnp.asarray(img0), pad)
    I0x = pad_constant(gx0, pad)
    I0y = pad_constant(gy0, pad)
    I1 = pad_replicate(jnp.asarray(img1), pad)
    tmpl, tgx, tgy, H = extract_templates_and_hessians(I0, I0x, I0y, grid, cfg)
    state = dis_mod.init_state(tmpl, tgx, tgy, H, grid)
    return state, I1, grid


def _smooth_noise(rng, h, w):
    """Band-limited random image so gradient descent has a basin."""
    small = rng.standard_normal((h // 4, w // 4, 3)).astype(np.float32)
    img = np.kron(small, np.ones((4, 4, 1), np.float32))
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(img, sigma=(2, 2, 0)).astype(np.float32) * 50 + 128


def test_recovers_integer_translation(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=16)
    h, w = 32, 48
    base = _smooth_noise(rng, h + 8, w + 8)
    img0 = base[4:4 + h, 4:4 + w]
    img1 = base[4 - 2:4 - 2 + h, 4 - 1:4 - 1 + w]  # I1(x) = I0(x - (1, 2))
    # flow I0 -> I1 is (+1, +2)
    state, I1, grid = _setup(img0, img1, cfg)
    state = _jit_optimize(state, I1, grid, cfg)
    p = np.asarray(state.p_cur)
    inner = p[2:-2, 2:-2]  # ignore patches touching the border
    med = np.median(inner.reshape(-1, 2), axis=0)
    np.testing.assert_allclose(med, [1.0, 2.0], atol=0.05)


def test_recovers_subpixel_translation(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=24)
    h, w = 32, 48
    yy, xx = np.mgrid[0:h + 8, 0:w + 8].astype(np.float32)
    base = (np.sin(xx * 0.3) + np.cos(yy * 0.22))[..., None]
    base = np.repeat(base, 3, axis=2).astype(np.float32) * 40 + 128
    img0 = base[4:4 + h, 4:4 + w]
    shift = 0.5
    img1 = ((np.sin((xx - shift) * 0.3) + np.cos(yy * 0.22))[..., None]
            .repeat(3, axis=2).astype(np.float32) * 40 + 128)[4:4 + h, 4:4 + w]
    state, I1, grid = _setup(img0, img1, cfg)
    state = _jit_optimize(state, I1, grid, cfg)
    p = np.asarray(state.p_cur)
    med = np.median(p[1:-1, 1:-1].reshape(-1, 2), axis=0)
    np.testing.assert_allclose(med, [shift, 0.0], atol=0.05)


def test_outlier_reset_restores_org(rng):
    """A patch pushed beyond ps/2 displacement resets to its init flow."""
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12)
    h, w = 24, 24
    img0 = _smooth_noise(rng, h, w)
    img1 = np.asarray(_smooth_noise(np.random.default_rng(1), h, w))
    state, I1, grid = _setup(img0, img1, cfg)
    state = _jit_optimize(state, I1, grid, cfg)
    p = np.asarray(state.p_cur)
    # All flows respect the outlier threshold relative to the (zero) init.
    assert (np.sqrt((p ** 2).sum(-1)) <= cfg.outlier_thresh + 1e-4).all()
    assert np.asarray(state.converged).all()


def test_init_from_coarser_nearest_and_oob():
    cfg = DISConfig(patch_size=8, patch_stride=0.4)
    h, w = 16, 16
    grid = PatchGrid.create(cfg, w, h)
    z = jnp.zeros((grid.n_h, grid.n_w, cfg.patch_size, cfg.patch_size, 3))
    H = jnp.ones((grid.n_h, grid.n_w, 3))
    state = dis_mod.init_state(z, z, z, H, grid)
    coarse = np.zeros((h // 2, w // 2, 2), np.float32)
    coarse[:, :, 0] = 1.5
    # patch (0,0) has midpoint (2,2) -> nearest lookup at coarse[1,1]
    coarse[1, 1] = 100.0  # will push that patch out of bounds
    st2 = dis_mod.init_from_coarser(state, jnp.asarray(coarse), grid)
    p = np.asarray(st2.p_cur)
    conv = np.asarray(st2.converged)
    # nearest lookup at floor(mid/2), scaled x2 (extract.cu:130-137)
    assert p[2, 2, 0] == 3.0 and p[2, 2, 1] == 0.0
    assert conv[0, 0]          # out-of-bounds warm start freezes the patch
    assert not conv[2, 2]
