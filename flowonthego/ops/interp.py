"""Bilinear patch sampling from the target image.

Equivalent of the interpolation step of kernelInterpolateAndComputeErr
(src/kernels/optimize.cu:125-170): for each patch, the four bilinear
weights are constant over the patch (pure translation), so the sampled
patch is a blend of four integer-shifted windows:

    value[r, c] = w3*W[r, c] + w2*W[r, c+1] + w1*W[r+1, c] + w0*W[r+1, c+1]

where W is the (ps+1)x(ps+1) window whose top-left sits at
(floor(my) - ps/2, floor(mx) - ps/2) and (rx, ry) = mid - floor(mid),
w0 = rx*ry, w1 = (1-rx)*ry, w2 = rx*(1-ry), w3 = (1-rx)*(1-ry)
(optimize.cu:133-143; the ceil(+1e-5)/floor index pair reduces to this).

The dynamic (ps+1)^2 window gather is a vmapped ``lax.dynamic_slice``,
which XLA lowers to one native gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_windows(img_pad: jax.Array, mid_x: jax.Array, mid_y: jax.Array,
                   patch_size: int, padding: int):
    """(ps+1)x(ps+1) windows + bilinear fractions for float midpoints.

    Returns (windows [n_h, n_w, ps+1, ps+1, C], rx, ry) where the bilinear
    sample is the 4-shift blend of ``windows`` with weights built from
    (rx, ry) — see :func:`sample_patches_bilinear`.
    """
    ps = patch_size
    n_h, n_w = mid_x.shape
    C = img_pad.shape[2]

    fx = jnp.floor(mid_x)
    fy = jnp.floor(mid_y)
    rx = mid_x - fx
    ry = mid_y - fy
    # not clamped here: lax.dynamic_slice wraps a negative start once and
    # clamps the window into the image
    start_y = (fy.astype(jnp.int32) + (padding - ps // 2)).reshape(-1)
    start_x = (fx.astype(jnp.int32) + (padding - ps // 2)).reshape(-1)

    def one_window(sy, sx):
        return jax.lax.dynamic_slice(img_pad, (sy, sx, 0),
                                     (ps + 1, ps + 1, C))

    windows = jax.vmap(one_window)(start_y, start_x)
    return windows.reshape(n_h, n_w, ps + 1, ps + 1, C), rx, ry


def blend_windows(windows: jax.Array, rx: jax.Array, ry: jax.Array) -> jax.Array:
    """Bilinear 4-shift blend of (ps+1)^2 windows -> ps x ps samples."""
    ps = windows.shape[2] - 1
    rx = rx[..., None, None, None]
    ry = ry[..., None, None, None]
    w_tl = (1.0 - rx) * (1.0 - ry)
    w_tr = rx * (1.0 - ry)
    w_bl = (1.0 - rx) * ry
    w_br = rx * ry
    return (w_tl * windows[:, :, :ps, :ps, :]
            + w_tr * windows[:, :, :ps, 1:, :]
            + w_bl * windows[:, :, 1:, :ps, :]
            + w_br * windows[:, :, 1:, 1:, :])


def sample_patches_bilinear(img_pad: jax.Array, mid_x: jax.Array,
                            mid_y: jax.Array, patch_size: int,
                            padding: int) -> jax.Array:
    """Sample ps x ps patches centered at float midpoints.

    img_pad: [Hp, Wp, C] padded image; mid_x/mid_y: [n_h, n_w] float
    midpoints in unpadded coordinates.  Returns [n_h, n_w, ps, ps, C].

    Midpoints are assumed within the valid box [l_bound, u_bound]
    (enforced by the optimizer's outlier reset, optimize.cu:71-88), so all
    windows land inside the padded image; dynamic_slice clamps regardless.
    """
    windows, rx, ry = gather_windows(img_pad, mid_x, mid_y, patch_size,
                                     padding)
    return blend_windows(windows, rx, ry)
