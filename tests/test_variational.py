"""Variational refinement components vs numpy oracles
(semantics of src/kernels/flowUtil.cu and src/refine_variational.cpp)."""

import numpy as np
import jax.numpy as jnp
import pytest

from flowonthego.config import DISConfig
from flowonthego.ops import variational as var


def test_deriv5_matches_stencil(rng):
    x = rng.standard_normal((6, 9)).astype(np.float32)
    out = np.asarray(var.deriv5(jnp.asarray(x), axis=1))
    xp = np.pad(x, ((0, 0), (2, 2)), mode="edge")
    ref = (8 * (xp[:, 3:-1] - xp[:, 1:-3]) - (xp[:, 4:] - xp[:, :-4])) / 12.0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_deriv3_matches_stencil(rng):
    x = rng.standard_normal((6, 9)).astype(np.float32)
    out = np.asarray(var.deriv3(jnp.asarray(x), axis=0))
    xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    ref = 0.5 * (xp[2:] - xp[:-2])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_warp_identity_and_shift(rng):
    img = rng.standard_normal((8, 10, 3)).astype(np.float32)
    z = jnp.zeros((8, 10), jnp.float32)
    warped, mask = var.warp_image(jnp.asarray(img), z, z)
    np.testing.assert_allclose(np.asarray(warped), img, rtol=1e-6)
    assert (np.asarray(mask) == 1).all()

    # integer shift by +1 in x: warped[j, i] = img[j, i+1]
    wx = jnp.ones((8, 10), jnp.float32)
    warped, mask = var.warp_image(jnp.asarray(img), wx, z)
    np.testing.assert_allclose(np.asarray(warped)[:, :-1], img[:, 1:],
                               rtol=1e-6)
    # out-of-bounds at the last column (xx = w) -> mask 0, clamped sample
    m = np.asarray(mask)
    assert (m[:, :-1] == 1).all() and (m[:, -1] == 0).all()


def test_warp_subpixel_oracle(rng):
    img = rng.standard_normal((6, 7, 1)).astype(np.float32)
    wx = np.full((6, 7), 0.25, np.float32)
    wy = np.full((6, 7), 0.5, np.float32)
    warped, _ = var.warp_image(jnp.asarray(img), jnp.asarray(wx),
                               jnp.asarray(wy))
    out = np.asarray(warped)[..., 0]
    for j in range(5):
        for i in range(6):
            ref = (img[j, i, 0] * 0.75 * 0.5 + img[j, i + 1, 0] * 0.25 * 0.5
                   + img[j + 1, i, 0] * 0.75 * 0.5
                   + img[j + 1, i + 1, 0] * 0.25 * 0.5)
            np.testing.assert_allclose(out[j, i], ref, rtol=1e-5)


def test_smoothness_sums_and_zero_edges(rng):
    uu = rng.standard_normal((6, 8)).astype(np.float32)
    vv = rng.standard_normal((6, 8)).astype(np.float32)
    sh, sv = var.compute_smoothness(jnp.asarray(uu), jnp.asarray(vv), 2.5)
    sh, sv = np.asarray(sh), np.asarray(sv)
    assert (sh[:, -1] == 0).all() and (sv[-1, :] == 0).all()
    assert (sh[:, :-1] > 0).all() and (sv[:-1, :] > 0).all()


def test_sub_laplacian_matches_loop(rng):
    h, w = 6, 7
    src = rng.standard_normal((h, w)).astype(np.float32)
    sh = np.abs(rng.standard_normal((h, w))).astype(np.float32)
    sv = np.abs(rng.standard_normal((h, w))).astype(np.float32)
    sh[:, -1] = 0
    sv[-1, :] = 0
    dst0 = rng.standard_normal((h, w)).astype(np.float32)
    out = np.asarray(var.sub_laplacian(jnp.asarray(dst0), jnp.asarray(src),
                                       jnp.asarray(sh), jnp.asarray(sv)))
    ref = dst0.astype(np.float64).copy()
    for j in range(h):
        for i in range(w):
            if i < w - 1:
                ref[j, i] += sh[j, i] * (src[j, i + 1] - src[j, i])
            if i > 0:
                ref[j, i] -= sh[j, i - 1] * (src[j, i] - src[j, i - 1])
            if j < h - 1:
                ref[j, i] += sv[j, i] * (src[j + 1, i] - src[j, i])
            if j > 0:
                ref[j, i] -= sv[j - 1, i] * (src[j, i] - src[j - 1, i])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def sor_oracle(du, dv, a11, a12, a22, b1, b2, sh, sv, iters, omega):
    """Sequential red-black SOR exactly as kernelSorStep
    (flowUtil.cu:297-362): odd cells then even cells, dv uses fresh du."""
    h, w = du.shape
    du, dv = du.copy().astype(np.float64), dv.copy().astype(np.float64)
    for _ in range(iters):
        for parity in (1, 0):
            snap_du, snap_dv = du.copy(), dv.copy()
            for j in range(h):
                for i in range(w):
                    if (i + j) % 2 != parity:
                        continue
                    sig_u = sig_v = sdp = 0.0
                    if j > 0:
                        sig_u -= sv[j - 1, i] * snap_du[j - 1, i]
                        sig_v -= sv[j - 1, i] * snap_dv[j - 1, i]
                        sdp += sv[j - 1, i]
                    if i > 0:
                        sig_u -= sh[j, i - 1] * snap_du[j, i - 1]
                        sig_v -= sh[j, i - 1] * snap_dv[j, i - 1]
                        sdp += sh[j, i - 1]
                    if j < h - 1:
                        sig_u -= sv[j, i] * snap_du[j + 1, i]
                        sig_v -= sv[j, i] * snap_dv[j + 1, i]
                        sdp += sv[j, i]
                    if i < w - 1:
                        sig_u -= sh[j, i] * snap_du[j, i + 1]
                        sig_v -= sh[j, i] * snap_dv[j, i + 1]
                        sdp += sh[j, i]
                    A11, A22 = a11[j, i] + sdp, a22[j, i] + sdp
                    B1, B2 = b1[j, i] - sig_u, b2[j, i] - sig_v
                    du[j, i] = ((1 - omega) * du[j, i]
                                + omega / A11 * (B1 - a12[j, i] * dv[j, i]))
                    dv[j, i] = ((1 - omega) * dv[j, i]
                                + omega / A22 * (B2 - a12[j, i] * du[j, i]))
    return du, dv


def test_sor_matches_sequential_oracle(rng):
    h, w = 6, 8
    a11 = (np.abs(rng.standard_normal((h, w))) + 1).astype(np.float32)
    a22 = (np.abs(rng.standard_normal((h, w))) + 1).astype(np.float32)
    a12 = (0.1 * rng.standard_normal((h, w))).astype(np.float32)
    b1 = rng.standard_normal((h, w)).astype(np.float32)
    b2 = rng.standard_normal((h, w)).astype(np.float32)
    sh = np.abs(rng.standard_normal((h, w))).astype(np.float32)
    sv = np.abs(rng.standard_normal((h, w))).astype(np.float32)
    sh[:, -1] = 0
    sv[-1, :] = 0
    du0 = np.zeros((h, w), np.float32)
    dv0 = np.zeros((h, w), np.float32)

    du, dv = var.sor_solve(jnp.asarray(du0), jnp.asarray(dv0),
                           jnp.asarray(a11), jnp.asarray(a12),
                           jnp.asarray(a22), jnp.asarray(b1),
                           jnp.asarray(b2), jnp.asarray(sh), jnp.asarray(sv),
                           iterations=3, omega=1.6)
    ref_du, ref_dv = sor_oracle(du0, dv0, a11, a12, a22, b1, b2, sh, sv,
                                3, 1.6)
    np.testing.assert_allclose(np.asarray(du), ref_du, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dv), ref_dv, rtol=1e-3, atol=1e-4)


def test_refine_pulls_flow_toward_truth(rng):
    """Refinement of a perturbed constant-shift flow reduces the error."""
    from scipy.ndimage import gaussian_filter
    h, w = 32, 40
    base = gaussian_filter(
        rng.standard_normal((h + 8, w + 8, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    im1 = base[4:4 + h, 4:4 + w]
    im2 = base[4:4 + h, 3:3 + w]   # I2(x) = I1(x + 1) -> true flow u = +1
    cfg = DISConfig()
    true_flow = np.zeros((h, w, 2), np.float32)
    true_flow[..., 0] = 1.0
    noisy = true_flow + 0.3 * rng.standard_normal((h, w, 2)).astype(np.float32)
    refined = np.asarray(var.variational_refine(
        jnp.asarray(noisy), jnp.asarray(im1), jnp.asarray(im2), cfg, level=3))
    err_before = np.abs(noisy - true_flow)[4:-4, 4:-4].mean()
    err_after = np.abs(refined - true_flow)[4:-4, 4:-4].mean()
    assert err_after < 0.5 * err_before


def _warp_oracle(src, wx, wy):
    """kernelWarpImage per pixel: bilinear with each tap clamped to the
    image, and a mask of samples whose position lies inside it."""
    h, w, C = src.shape
    out = np.zeros_like(src, dtype=np.float64)
    mask = np.zeros((h, w))
    for j in range(h):
        for i in range(w):
            x, y = i + wx[j, i], j + wy[j, i]
            mask[j, i] = (0 <= x < w) and (0 <= y < h)
            x0, y0 = np.floor(x), np.floor(y)
            dx, dy = x - x0, y - y0
            xs = [int(np.clip(x0, 0, w - 1)), int(np.clip(x0 + 1, 0, w - 1))]
            ys = [int(np.clip(y0, 0, h - 1)), int(np.clip(y0 + 1, 0, h - 1))]
            out[j, i] = (src[ys[0], xs[0]] * (1 - dx) * (1 - dy)
                         + src[ys[0], xs[1]] * dx * (1 - dy)
                         + src[ys[1], xs[0]] * (1 - dx) * dy
                         + src[ys[1], xs[1]] * dx * dy)
    return out, mask


@pytest.mark.parametrize("shift", [(-3.3, -2.7), (2.6, 3.2), (0.0, 0.0)])
def test_warp_gather_matches_oracle_at_borders(rng, shift):
    """The gather warp == the per-pixel oracle, including samples that
    leave the image on every side (clamped taps, zero mask)."""
    h, w = 9, 11
    src = rng.random((h, w, 3)).astype(np.float32) * 255
    wx = (shift[0] + rng.standard_normal((h, w)) * 2).astype(np.float32)
    wy = (shift[1] + rng.standard_normal((h, w)) * 2).astype(np.float32)
    got, mask = var.warp_image(jnp.asarray(src), jnp.asarray(wx),
                               jnp.asarray(wy))
    ref, ref_mask = _warp_oracle(src, wx, wy)
    np.testing.assert_array_equal(np.asarray(mask), ref_mask)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-3)


def _sor_oracle(du, dv, a11, a12, a22, b1, b2, s_h, s_v, iters, omega):
    """Red-black SOR (cu::sor, flowUtil.cu:651-706) as sequential
    per-pixel loops: odd cells, then even cells, each cell updating du
    then dv from the freshly written du."""
    du = du.astype(np.float64).copy()
    dv = dv.astype(np.float64).copy()
    h, w = du.shape

    def at(x, j, i):
        return x[j, i] if 0 <= j < h and 0 <= i < w else 0.0

    for _ in range(iters):
        for parity in (1, 0):
            for j in range(h):
                for i in range(w):
                    if (i + j) % 2 != parity:
                        continue
                    sv_up, sh_l = at(s_v, j - 1, i), at(s_h, j, i - 1)
                    A = sv_up + sh_l + s_v[j, i] + s_h[j, i]
                    nu = (sv_up * at(du, j - 1, i) + sh_l * at(du, j, i - 1)
                          + s_v[j, i] * at(du, j + 1, i)
                          + s_h[j, i] * at(du, j, i + 1))
                    nv = (sv_up * at(dv, j - 1, i) + sh_l * at(dv, j, i - 1)
                          + s_v[j, i] * at(dv, j + 1, i)
                          + s_h[j, i] * at(dv, j, i + 1))
                    du[j, i] = ((1 - omega) * du[j, i] + omega / (a11[j, i] + A)
                                * (b1[j, i] + nu - a12[j, i] * dv[j, i]))
                    dv[j, i] = ((1 - omega) * dv[j, i] + omega / (a22[j, i] + A)
                                * (b2[j, i] + nv - a12[j, i] * du[j, i]))
    return du, dv


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_varref_matches_sequential_sor_oracle(rng, level):
    """variational_refine (red-black sweeps as checkerboard-masked
    stencils) == the same fixed-point iterations with the SOR solved by
    sequential per-pixel loops, at inner-iteration counts level + 1."""
    from scipy.ndimage import gaussian_filter
    h, w = 12, 16
    base = gaussian_filter(rng.standard_normal((h + 8, w + 8, 3)),
                           sigma=(2, 2, 0)).astype(np.float32) * 120 + 128
    im1 = jnp.asarray(base[4:4 + h, 4:4 + w])
    im2 = jnp.asarray(base[4:4 + h, 3:3 + w])
    flow = jnp.asarray(0.3 * rng.standard_normal((h, w, 2)).astype(
        np.float32) + np.array([1.0, 0.0], np.float32))
    cfg = DISConfig()
    got = np.asarray(var.variational_refine(flow, im1, im2, cfg, level))

    qa = 0.25 * cfg.var_ref_alpha
    hd3 = cfg.var_ref_delta * 0.5 / 3.0
    hg3 = cfg.var_ref_gamma * 0.5 / 3.0
    wx, wy = flow[..., 0], flow[..., 1]
    w_im2, mask = var.warp_image(im2, wx, wy)
    d = var.get_derivatives(im1, w_im2)
    du = np.zeros((h, w))
    dv = np.zeros((h, w))
    uu, vv = wx, wy
    for _ in range(level + 1):
        s_h, s_v = var.compute_smoothness(uu, vv, qa)
        a11, a12, a22, b1, b2 = var.data_term(
            mask, jnp.asarray(du, jnp.float32), jnp.asarray(dv, jnp.float32),
            d, hd3, hg3)
        b1 = var.sub_laplacian(b1, wx, s_h, s_v)
        b2 = var.sub_laplacian(b2, wy, s_h, s_v)
        du, dv = _sor_oracle(du, dv, *(np.asarray(x, np.float64) for x in (
            a11, a12, a22, b1, b2, s_h, s_v)), cfg.var_ref_iter,
            cfg.var_ref_sor_weight)
        uu = wx + jnp.asarray(du, jnp.float32)
        vv = wy + jnp.asarray(dv, jnp.float32)
    ref = np.stack([np.asarray(uu), np.asarray(vv)], -1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
