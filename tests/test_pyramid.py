"""Pyramid ops vs numpy oracles (semantics of src/kernels/pyramid.cpp)."""

import numpy as np
import jax.numpy as jnp
import pytest

from flowonthego.ops.pyramid import (build_pyramid, central_diff,
                                     downsample_half, pad_replicate,
                                     pad_constant)


def test_downsample_is_2x2_mean(rng):
    img = rng.standard_normal((8, 12, 3)).astype(np.float32)
    out = np.asarray(downsample_half(jnp.asarray(img)))
    expect = img.reshape(4, 2, 6, 2, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-6)


def test_central_diff_matches_loop(rng):
    img = rng.standard_normal((6, 7, 3)).astype(np.float32)
    gx, gy = central_diff(jnp.asarray(img))
    gx, gy = np.asarray(gx), np.asarray(gy)
    h, w, _ = img.shape
    for y in range(h):
        for x in range(w):
            xm, xp = max(x - 1, 0), min(x + 1, w - 1)
            ym, yp = max(y - 1, 0), min(y + 1, h - 1)
            np.testing.assert_allclose(gx[y, x], img[y, xp] - img[y, xm],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(gy[y, x], img[yp, x] - img[ym, x],
                                       rtol=1e-5, atol=1e-6)


def test_padding_modes(rng):
    img = rng.standard_normal((4, 5, 2)).astype(np.float32)
    rep = np.asarray(pad_replicate(jnp.asarray(img), 3))
    assert rep.shape == (10, 11, 2)
    np.testing.assert_array_equal(rep[0, 0], img[0, 0])
    np.testing.assert_array_equal(rep[-1, -1], img[-1, -1])
    np.testing.assert_array_equal(rep[3:7, 3:8], img)

    zer = np.asarray(pad_constant(jnp.asarray(img), 2))
    assert zer.shape == (8, 9, 2)
    assert (zer[:2] == 0).all() and (zer[:, :2] == 0).all()
    np.testing.assert_array_equal(zer[2:6, 2:7], img)


def test_build_pyramid_levels(rng):
    img = rng.standard_normal((16, 32, 3)).astype(np.float32)
    pyr = build_pyramid(jnp.asarray(img), n_levels=3, padding=4)
    assert len(pyr) == 3
    assert pyr[0].image.shape == (16 + 8, 32 + 8, 3)
    assert pyr[1].image.shape == (8 + 8, 16 + 8, 3)
    assert pyr[2].image.shape == (4 + 8, 8 + 8, 3)
    # level 1 is the 2x2 mean of level 0; its gradients are zero-padded
    lvl1 = np.asarray(pyr[1].image)[4:-4, 4:-4]
    np.testing.assert_allclose(lvl1, img.reshape(8, 2, 16, 2, 3).mean((1, 3)),
                               rtol=1e-5, atol=1e-6)
    assert (np.asarray(pyr[1].grad_x)[:4] == 0).all()


def _pool_oracle(x, C, bias=0.0):
    """2x2 mean of a flat [h, w*C] image in float64, dropping an odd
    trailing row or column."""
    x = np.asarray(x, np.float64) + bias
    h, w = x.shape[0] // 2, x.shape[1] // (2 * C)
    x = x[:2 * h, :2 * w * C].reshape(h, 2, w, 2, C)
    return x.mean(axis=(1, 3)).reshape(h, w * C)


@pytest.mark.parametrize("h,w,C,dtype,bias", [
    (40, 322, 3, np.float32, None),     # flat width 966: not a power of 2
    (34, 61, 3, np.float32, None),      # odd pixel width: last column off
    (33, 64, 1, np.float32, None),      # odd height, gray
    (40, 322, 3, np.uint8, None),       # uint8 ingest, upcast in the pool
    (40, 322, 3, np.float32, 3.25),     # fused ingest bias
    (36, 50, 1, np.uint8, 1.5),         # uint8 + bias, gray
])
def test_pool_matches_numpy_oracle(rng, h, w, C, dtype, bias):
    from flowonthego.ops.pyramid import _downsample_half_flat
    x = (rng.random((h, w * C)) * 255).astype(dtype)
    b = None if bias is None else jnp.float32(bias)
    got = np.asarray(_downsample_half_flat(jnp.asarray(x), C, bias=b))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _pool_oracle(x, C, bias or 0.0),
                               rtol=1e-6, atol=1e-4)


def test_build_pyramid_uint8(rng):
    """build_pyramid on uint8 equals build_pyramid on its float32 cast,
    with and without a start_level (which routes the upcast through the
    first pool's read)."""
    u8 = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
    for start in (0, 1):
        pu = build_pyramid(jnp.asarray(u8), 3, 4, start_level=start)
        pf = build_pyramid(jnp.asarray(u8, jnp.float32), 3, 4,
                           start_level=start)
        for lu, lf in zip(pu, pf):
            np.testing.assert_array_equal(
                np.asarray(lu.image, np.float32), np.asarray(lf.image))


def test_build_pyramid_ingest_bias(rng):
    """build_pyramid(img, ingest_bias=b) == build_pyramid(img + b) on the
    processed levels (start_level and coarser)."""
    img = jnp.asarray(rng.random((32, 48, 3)).astype(np.float32) * 255)
    b = jnp.float32(0.125)
    fused = build_pyramid(img, 3, padding=4, start_level=1, ingest_bias=b)
    plain = build_pyramid(img + b, 3, padding=4, start_level=1)
    for lvl in range(1, 3):
        for a, r in zip(fused[lvl], plain[lvl]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                       rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError):
        build_pyramid(img, 3, padding=4, start_level=0, ingest_bias=b)
