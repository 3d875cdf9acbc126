"""Bilinear patch sampling vs a per-pixel numpy oracle
(semantics of src/kernels/optimize.cu:125-170)."""

import numpy as np
import jax.numpy as jnp
import pytest

from flowonthego.ops.interp import sample_patches_bilinear


def bilinear_oracle(img_pad, mx, my, ps, padding):
    """Direct per-pixel bilinear sample at (mx + dx, my + dy) for
    dx, dy in [-ps/2, ps/2)."""
    C = img_pad.shape[2]
    out = np.zeros((ps, ps, C), np.float64)
    for r in range(ps):
        for c in range(ps):
            x = mx + c - ps // 2
            y = my + r - ps // 2
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            fx, fy = x - x0, y - y0
            xp, yp = x0 + padding, y0 + padding
            out[r, c] = (img_pad[yp, xp] * (1 - fx) * (1 - fy)
                         + img_pad[yp, xp + 1] * fx * (1 - fy)
                         + img_pad[yp + 1, xp] * (1 - fx) * fy
                         + img_pad[yp + 1, xp + 1] * fx * fy)
    return out


def test_bilinear_matches_oracle(rng):
    ps, pad = 8, 8
    img_pad = rng.standard_normal((40, 48, 3)).astype(np.float32)
    mids = [(12.0, 10.0), (12.3, 9.7), (15.99, 8.01), (10.5, 10.5)]
    mx = np.array([[m[0] for m in mids]], np.float32)
    my = np.array([[m[1] for m in mids]], np.float32)
    out = np.asarray(sample_patches_bilinear(jnp.asarray(img_pad),
                                             jnp.asarray(mx), jnp.asarray(my),
                                             ps, pad))
    for i, (x, y) in enumerate(mids):
        ref = bilinear_oracle(img_pad, x, y, ps, pad)
        np.testing.assert_allclose(out[0, i], ref, rtol=1e-4, atol=1e-4)


def test_integer_midpoint_is_direct_window(rng):
    ps, pad = 8, 8
    img_pad = rng.standard_normal((40, 40, 3)).astype(np.float32)
    mx = np.array([[10.0]], np.float32)
    my = np.array([[12.0]], np.float32)
    out = np.asarray(sample_patches_bilinear(jnp.asarray(img_pad),
                                             jnp.asarray(mx), jnp.asarray(my),
                                             ps, pad))
    ref = img_pad[12 + pad - ps // 2: 12 + pad + ps // 2,
                  10 + pad - ps // 2: 10 + pad + ps // 2]
    np.testing.assert_array_equal(out[0, 0], ref)


@pytest.mark.parametrize("mid", [(-9.5, 2.25), (40.75, 33.5)])
def test_window_gather_clamps_at_borders(rng, mid):
    """Windows whose start leaves the padded image follow lax.dynamic_slice
    semantics — a negative start wraps once, then the start is clamped to
    keep the window inside (the GN kernel reproduces exactly this); the
    bilinear fractions stay those of the unclamped midpoint."""
    from flowonthego.ops.interp import gather_windows
    ps, pad = 8, 8
    img_pad = rng.standard_normal((30, 26, 3)).astype(np.float32)
    Hp, Wp, _ = img_pad.shape
    K = ps + 1
    mx = np.array([[mid[0]]], np.float32)
    my = np.array([[mid[1]]], np.float32)
    win, rx, ry = gather_windows(jnp.asarray(img_pad), jnp.asarray(mx),
                                 jnp.asarray(my), ps, pad)
    sy = int(np.floor(mid[1]) + pad - ps // 2)
    sx = int(np.floor(mid[0]) + pad - ps // 2)
    sy = int(np.clip(sy + Hp if sy < 0 else sy, 0, Hp - K))
    sx = int(np.clip(sx + Wp if sx < 0 else sx, 0, Wp - K))
    np.testing.assert_array_equal(np.asarray(win)[0, 0],
                                  img_pad[sy:sy + K, sx:sx + K])
    np.testing.assert_allclose(float(rx[0, 0]), mid[0] - np.floor(mid[0]))
    np.testing.assert_allclose(float(ry[0, 0]), mid[1] - np.floor(mid[1]))
