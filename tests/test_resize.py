"""Direct tests for ops/resize.py — load-bearing for the final upsample
(run_dense.cpp:294-299 semantics) and the sharded strip upsample.

Covers: gather form vs matmul form vs jax.image.resize equivalence, and
resize_rows_strip (traced offsets) vs rows of the full resize.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flowonthego.ops.resize import (resize_full, resize_matmul,
                                    resize_rows_strip)


@pytest.mark.parametrize("shape,out", [
    ((13, 17, 2), (26, 34)),     # exact x2 (the flow upsample case)
    ((13, 17, 2), (52, 68)),     # x4
    ((16, 16, 3), (36, 24)),     # non-integer, anisotropic
    ((9, 7, 1), (5, 3)),         # downscale
])
def test_resize_forms_agree(rng, shape, out):
    img = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 50)
    a = np.asarray(resize_full(img, *out))
    b = np.asarray(resize_matmul(img, *out))
    c = np.asarray(jax.image.resize(img, out + (shape[2],), "linear",
                                    antialias=False))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    # jax.image.resize blends in a different order; tolerance is fp-level
    np.testing.assert_allclose(a, c, rtol=5e-4, atol=5e-4)


def test_resize_matmul_matches_opencv_convention():
    """Half-pixel centers + edge clamp: a x2 upsample of a ramp keeps the
    endpoints clamped and midpoints interpolated (INTER_LINEAR)."""
    img = jnp.asarray(np.arange(4, dtype=np.float32).reshape(1, 4, 1))
    out = np.asarray(resize_matmul(img, 1, 8)).reshape(-1)
    expected = np.array([0.0, 0.25, 0.75, 1.25, 1.75, 2.25, 2.75, 3.0],
                        np.float32)
    np.testing.assert_allclose(out, expected, atol=1e-6)


@pytest.mark.parametrize("scale", [2.0, 4.0])
def test_resize_rows_strip_matches_full(rng, scale):
    h, w, c = 16, 12, 2
    img = jnp.asarray(rng.standard_normal((h, w, c)).astype(np.float32))
    out_h, out_w = int(h * scale), int(w * scale)
    full = np.asarray(resize_full(img, out_h, out_w))
    rows = out_h // 4

    @jax.jit
    def strip(start):
        return resize_rows_strip(img, scale, scale, start, rows, out_w)

    for k in range(4):
        start = jnp.int32(k * rows)          # traced offset
        got = np.asarray(strip(start))
        np.testing.assert_allclose(got, full[k * rows:(k + 1) * rows],
                                   rtol=1e-5, atol=1e-5)
