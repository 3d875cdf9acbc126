"""Explicit bilinear resize (half-pixel centers, edge clamp).

Matches ``jax.image.resize(method='linear', antialias=False)`` / OpenCV
INTER_LINEAR upsampling semantics (the reference's final flow upscale,
src/run_dense.cpp:294-299), but exposed as gather math so the spatially
sharded path can produce just its own row strip with a dynamic row
offset (parallel/spatial.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _axis_coords(out_start, out_len: int, scale: float, in_len: int):
    """Source coords for output samples [out_start, out_start+out_len).

    src = (dst + 0.5) * (in/out) - 0.5 with in/out = 1/scale; clamped taps.
    Returns (i0, i1, frac) — lower/upper tap indices and blend weight.
    """
    j = out_start + jnp.arange(out_len, dtype=jnp.float32)
    src = (j + 0.5) / scale - 0.5
    src = jnp.clip(src, 0.0, float(in_len - 1))
    i0 = jnp.floor(src)
    frac = src - i0
    i0 = i0.astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, in_len - 1)
    return i0, i1, frac


def resize_full(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Standard full-frame bilinear resize [H, W, C] -> [out_h, out_w, C]."""
    h, w = img.shape[0], img.shape[1]
    y0, y1, fy = _axis_coords(0, out_h, out_h / h, h)
    x0, x1, fx = _axis_coords(0, out_w, out_w / w, w)
    top = img[y0][:, x0] * (1 - fx)[None, :, None] + \
        img[y0][:, x1] * fx[None, :, None]
    bot = img[y1][:, x0] * (1 - fx)[None, :, None] + \
        img[y1][:, x1] * fx[None, :, None]
    return top * (1 - fy)[:, None, None] + bot * fy[:, None, None]


def _interp_matrix(out_len: int, in_len: int) -> "np.ndarray":
    """Dense [out, in] bilinear interpolation matrix (half-pixel, clamped).

    Each row has <= 2 nonzeros; built once per (static) shape pair so the
    resize becomes two matmuls.
    """
    import numpy as np
    j = np.arange(out_len, dtype=np.float64)
    src = np.clip((j + 0.5) * in_len / out_len - 0.5, 0.0, in_len - 1)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    i1 = np.minimum(i0 + 1, in_len - 1)
    R = np.zeros((out_len, in_len), np.float32)
    R[j.astype(np.int64), i0] += (1.0 - frac).astype(np.float32)
    R[j.astype(np.int64), i1] += frac.astype(np.float32)
    return R


def resize_matmul(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Bilinear resize [H, W, C] -> [out_h, out_w, C] as two matmuls.

    Numerically equivalent to :func:`resize_full` (same half-pixel/clamp
    convention): the 2-tap row/col blends applied as dense contractions.

    Both contractions run at HIGHEST precision: the operand is flow in
    pixels (up to ~100 px after the x2^fs scaling), and a TF32 product
    keeps 10 mantissa bits, i.e. errors of ~0.1 px — the size of the EPE
    this pipeline is judged by.  At full f32 the result matches
    :func:`resize_full` to float32 rounding.
    """
    h, w, c = img.shape
    Rv = jnp.asarray(_interp_matrix(out_h, h))
    Rh = jnp.asarray(_interp_matrix(out_w, w))
    hi = jax.lax.Precision.HIGHEST
    tmp = jnp.einsum("oh,hwc->owc", Rv, img, precision=hi,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("pw,owc->opc", Rh, tmp, precision=hi,
                      preferred_element_type=jnp.float32)


def resize_rows_strip(img: jax.Array, scale_h: float, scale_w: float,
                      row_start, out_rows: int, out_w: int) -> jax.Array:
    """Rows [row_start, row_start+out_rows) of the bilinear resize of
    ``img`` by (scale_h, scale_w).  ``row_start`` may be traced — this is
    the sharded-upsample primitive (each shard computes only its strip)."""
    h, w = img.shape[0], img.shape[1]
    y0, y1, fy = _axis_coords(row_start, out_rows, scale_h, h)
    x0, x1, fx = _axis_coords(0, out_w, scale_w, w)
    top = img[y0][:, x0] * (1 - fx)[None, :, None] + \
        img[y0][:, x1] * fx[None, :, None]
    bot = img[y1][:, x0] * (1 - fx)[None, :, None] + \
        img[y1][:, x1] * fx[None, :, None]
    return top * (1 - fy)[:, None, None] + bot * fy[:, None, None]
