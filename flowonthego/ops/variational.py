"""Variational (Brox/DeepFlow-style) refinement — dense XLA stencils.

Equivalent of the reference's refinement stage
(src/refine_variational.cpp:32-253 and src/kernels/flowUtil.cu).
Everything is a fused elementwise/stencil op on [H, W(, 3)] tensors at the
current pyramid scale; the red-black SOR sweep is expressed with
checkerboard masks, one colour after the other, as the reference's
one-launch-per-colour sweep does.

Energy constants follow flowUtil.cu:21-25:
    datanorm = 0.1^2, epsilon_color = epsilon_grad = epsilon_smooth = 0.001^2
and the weight plumbing refine_variational.cpp:45-47:
    quarter_alpha = alpha/4, half_delta_over3 = delta/6, half_gamma_over3 = gamma/6.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DISConfig

DATANORM = 0.1 * 0.1
EPS_COLOR = 0.001 * 0.001
EPS_GRAD = 0.001 * 0.001
EPS_SMOOTH = 0.001 * 0.001


# ---------------------------------------------------------------- derivatives

def _pad_edge(x: jax.Array, n: int, axis: int) -> jax.Array:
    cfg = [(0, 0)] * x.ndim
    cfg[axis] = (n, n)
    return jnp.pad(x, cfg, mode="edge")


def deriv5(x: jax.Array, axis: int) -> jax.Array:
    """4th-order central difference, replicate border.

    (8*(x[i+1] - x[i-1]) - (x[i+2] - x[i-2])) / 12 — the FDF 5-tap filter
    {1/12, -8/12, 0, 8/12, -1/12} (kroeger/refine_variational.cpp:45-46,
    FDF1.0.1/image.c:327-374), used by cu::colorImageDerivative
    (flowUtil.cu:733-765).
    """
    p = _pad_edge(x, 2, axis)
    sl = lambda lo, hi: jax.lax.slice_in_dim(p, lo, hi, axis=axis)
    n = x.shape[axis]
    return (8.0 * (sl(3, 3 + n) - sl(1, 1 + n)) - (sl(4, 4 + n) - sl(0, n))) / 12.0


def deriv3(x: jax.Array, axis: int) -> jax.Array:
    """0.5 * (x[i+1] - x[i-1]), replicate border — the FDF 3-tap flow
    derivative {0.5, 0, -0.5} (cu::imageDerivative, flowUtil.cu:767-801)."""
    p = _pad_edge(x, 1, axis)
    sl = lambda lo, hi: jax.lax.slice_in_dim(p, lo, hi, axis=axis)
    n = x.shape[axis]
    return 0.5 * (sl(2, 2 + n) - sl(0, n))


# ------------------------------------------------------------------- warping

def _warp_corners(src, wx, wy):
    """Shared corner/blend geometry of kernelWarpImage (flowUtil.cu:448-493)."""
    h, w = src.shape[:2]
    jj = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    ii = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    xx = ii + wx
    yy = jj + wy
    x0 = jnp.floor(xx)
    y0 = jnp.floor(yy)
    dx = xx - x0
    dy = yy - y0
    mask = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)).astype(src.dtype)
    x1 = jnp.clip(x0, 0, w - 1).astype(jnp.int32)
    x2 = jnp.clip(x0 + 1, 0, w - 1).astype(jnp.int32)
    y1 = jnp.clip(y0, 0, h - 1).astype(jnp.int32)
    y2 = jnp.clip(y0 + 1, 0, h - 1).astype(jnp.int32)
    return mask, x1, x2, y1, y2, dx, dy


def warp_image(src: jax.Array, wx: jax.Array, wy: jax.Array):
    """Backward-warp ``src`` [H, W, C] by flow (wx, wy) [H, W].

    Bilinear with per-tap clamping + in-bounds mask, matching
    kernelWarpImage (flowUtil.cu:448-493): four corner gathers, which the
    GPU runs natively (every refined field fits in L2).  Returns
    (warped [H, W, C], mask [H, W]).
    """
    mask, x1, x2, y1, y2, dx, dy = _warp_corners(src, wx, wy)
    dxe = dx[..., None]
    dye = dy[..., None]
    warped = (src[y1, x1] * (1 - dxe) * (1 - dye)
              + src[y1, x2] * dxe * (1 - dye)
              + src[y2, x1] * (1 - dxe) * dye
              + src[y2, x2] * dxe * dye)
    return warped, mask


# --------------------------------------------------------------- derivatives

class Derivatives(NamedTuple):
    Ix: jax.Array
    Iy: jax.Array
    Iz: jax.Array
    Ixx: jax.Array
    Ixy: jax.Array
    Iyy: jax.Array
    Ixz: jax.Array
    Iyz: jax.Array


def get_derivatives(im1: jax.Array, w_im2: jax.Array) -> Derivatives:
    """Spatial/temporal derivatives on the mean of im1 and warped im2
    (cu::getDerivatives, flowUtil.cu:929-954)."""
    mean = 0.5 * (im1 + w_im2)
    Iz = w_im2 - im1
    Ix = deriv5(mean, axis=1)
    Iy = deriv5(mean, axis=0)
    return Derivatives(
        Ix=Ix, Iy=Iy, Iz=Iz,
        Ixx=deriv5(Ix, axis=1),
        Ixy=deriv5(Ix, axis=0),
        Iyy=deriv5(Iy, axis=0),
        Ixz=deriv5(Iz, axis=1),
        Iyz=deriv5(Iz, axis=0),
    )


# ---------------------------------------------------------------- smoothness

def compute_smoothness(uu: jax.Array, vv: jax.Array, quarter_alpha: float):
    """Diffusivity and its horizontal/vertical pair sums.

    s = alpha/4 / sqrt(|grad u|^2 + |grad v|^2 + eps)   (kernelFlowMag)
    s_horiz[j,i] = s[j,i] + s[j,i+1]  (last column zero)
    s_vert [j,i] = s[j,i] + s[j+1,i]  (last row zero)
    (cu::computeSmoothness, flowUtil.cu:390-423, 896-927.)
    """
    ux = deriv3(uu, axis=1)
    uy = deriv3(uu, axis=0)
    vx = deriv3(vv, axis=1)
    vy = deriv3(vv, axis=0)
    s = quarter_alpha / jnp.sqrt(ux * ux + uy * uy + vx * vx + vy * vy
                                 + EPS_SMOOTH)
    zc = jnp.zeros_like(s[:, :1])
    zr = jnp.zeros_like(s[:1, :])
    s_horiz = jnp.concatenate([s[:, :-1] + s[:, 1:], zc], axis=1)
    s_vert = jnp.concatenate([s[:-1, :] + s[1:, :], zr], axis=0)
    return s_horiz, s_vert


# ----------------------------------------------------------------- data term

def data_term(mask: jax.Array, du: jax.Array, dv: jax.Array, d: Derivatives,
              half_delta_over3: float, half_gamma_over3: float):
    """Robust color + gradient constancy normal equations.

    Per-pixel 2x2 system (a11, a12, a22, b1, b2) — kernelDataTerm
    (flowUtil.cu:27-151), channels summed with per-channel normalization
    n_c and a shared robust weight 1/sqrt(sum_c r_c^2/n_c + eps).
    """
    dtype = du.dtype
    a11 = jnp.zeros_like(du)
    a12 = jnp.zeros_like(du)
    a22 = jnp.zeros_like(du)
    b1 = jnp.zeros_like(du)
    b2 = jnp.zeros_like(du)

    due = du[..., None]
    dve = dv[..., None]

    if half_delta_over3 != 0.0:
        # color constancy
        r = d.Iz + d.Ix * due + d.Iy * dve                # [H, W, 3]
        n = d.Ix * d.Ix + d.Iy * d.Iy + DATANORM
        t = mask * half_delta_over3 / jnp.sqrt(
            (r * r / n).sum(-1) + EPS_COLOR)              # [H, W]
        tc = t[..., None] / n
        a11 += (tc * d.Ix * d.Ix).sum(-1)
        a12 += (tc * d.Ix * d.Iy).sum(-1)
        a22 += (tc * d.Iy * d.Iy).sum(-1)
        b1 -= (tc * d.Iz * d.Ix).sum(-1)
        b2 -= (tc * d.Iz * d.Iy).sum(-1)

    # gradient constancy
    n1 = d.Ixx * d.Ixx + d.Ixy * d.Ixy + DATANORM
    n2 = d.Iyy * d.Iyy + d.Ixy * d.Ixy + DATANORM
    r1 = d.Ixz + d.Ixx * due + d.Ixy * dve
    r2 = d.Iyz + d.Ixy * due + d.Iyy * dve
    t = mask * half_gamma_over3 / jnp.sqrt(
        (r1 * r1 / n1 + r2 * r2 / n2).sum(-1) + EPS_GRAD)
    t1 = t[..., None] / n1
    t2 = t[..., None] / n2
    a11 += (t1 * d.Ixx * d.Ixx + t2 * d.Ixy * d.Ixy).sum(-1)
    a12 += (t1 * d.Ixx * d.Ixy + t2 * d.Ixy * d.Iyy).sum(-1)
    a22 += (t2 * d.Iyy * d.Iyy + t1 * d.Ixy * d.Ixy).sum(-1)
    b1 -= (t1 * d.Ixx * d.Ixz + t2 * d.Ixy * d.Iyz).sum(-1)
    b2 -= (t2 * d.Iyy * d.Iyz + t1 * d.Ixy * d.Ixz).sum(-1)

    return a11.astype(dtype), a12.astype(dtype), a22.astype(dtype), \
        b1.astype(dtype), b2.astype(dtype)


# ------------------------------------------------------------- sub-Laplacian

def sub_laplacian(dst: jax.Array, src: jax.Array, s_horiz: jax.Array,
                  s_vert: jax.Array) -> jax.Array:
    """dst += weighted 5-point Laplacian of src.

    Horizontal: coeff = s_h * (src[.,i+1] - src[.,i]); dst += coeff -
    coeff[.,i-1].  Vertical analogously (kernelSubLaplacianHoriz*/Vert,
    flowUtil.cu:153-295).  s_h's last column / s_v's last row are zero, so
    no out-of-range taps contribute.
    """
    src_r = jnp.concatenate([src[:, 1:], src[:, -1:]], axis=1)
    coeff_h = s_horiz * (src_r - src)                    # zero in last col
    zc = jnp.zeros_like(coeff_h[:, :1])
    dst = dst + coeff_h - jnp.concatenate([zc, coeff_h[:, :-1]], axis=1)

    src_d = jnp.concatenate([src[1:, :], src[-1:, :]], axis=0)
    coeff_v = s_vert * (src_d - src)                     # zero in last row
    zr = jnp.zeros_like(coeff_v[:1, :])
    dst = dst + coeff_v - jnp.concatenate([zr, coeff_v[:-1, :]], axis=0)
    return dst


# ------------------------------------------------------------------ SOR

def sor_solve(du, dv, a11, a12, a22, b1, b2, s_horiz, s_vert,
              iterations: int, omega: float):
    """Red-black coupled SOR for the per-pixel 2x2 systems.

    Each iteration does an odd-checkerboard then an even-checkerboard
    half-sweep (cu::sor, flowUtil.cu:651-706); within a cell the dv update
    uses the freshly-written du (flowUtil.cu:358-359).
    """
    h, w = du.shape
    jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    parity = (ii + jj) % 2

    def shift(x, dy, dx):
        """x shifted so result[j,i] = x[j+dy, i+dx], zero-filled."""
        pad_cfg = ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0)))
        xp = jnp.pad(x, pad_cfg)
        return xp[max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]

    s_vert_up = shift(s_vert, -1, 0)     # vert[j-1, i]
    s_horiz_left = shift(s_horiz, 0, -1)  # horiz[j, i-1]
    sum_dpsis = s_vert_up + s_horiz_left + s_vert + s_horiz
    A11 = a11 + sum_dpsis
    A22 = a22 + sum_dpsis

    def half_sweep(du, dv, want_parity):
        sigma_u = -(s_vert_up * shift(du, -1, 0)
                    + s_horiz_left * shift(du, 0, -1)
                    + s_vert * shift(du, 1, 0)
                    + s_horiz * shift(du, 0, 1))
        sigma_v = -(s_vert_up * shift(dv, -1, 0)
                    + s_horiz_left * shift(dv, 0, -1)
                    + s_vert * shift(dv, 1, 0)
                    + s_horiz * shift(dv, 0, 1))
        B1 = b1 - sigma_u
        B2 = b2 - sigma_v
        du_new = (1.0 - omega) * du + omega / A11 * (B1 - a12 * dv)
        dv_new = (1.0 - omega) * dv + omega / A22 * (B2 - a12 * du_new)
        sel = parity == want_parity
        return jnp.where(sel, du_new, du), jnp.where(sel, dv_new, dv)

    def body(_, carry):
        du, dv = carry
        du, dv = half_sweep(du, dv, 1)   # odd first (flowUtil.cu:688)
        du, dv = half_sweep(du, dv, 0)
        return du, dv

    return jax.lax.fori_loop(0, iterations, body, (du, dv))


# ------------------------------------------------------------- orchestration

def variational_refine(flow: jax.Array, im1: jax.Array, im2: jax.Array,
                       cfg: DISConfig, level: int) -> jax.Array:
    """Refine a dense [H, W, 2] flow against unpadded scale images.

    Equivalent of VarRefClass + RefLevelOF
    (refine_variational.cpp:32-246): warp + derivatives once, then
    ``level + 1`` fixed-point iterations of {smoothness, data term,
    sub-Laplacian, SOR, flow update}.
    """
    inner_iter = level + 1                      # refine_variational.cpp:41
    qa = 0.25 * cfg.var_ref_alpha
    hd3 = cfg.var_ref_delta * 0.5 / 3.0
    hg3 = cfg.var_ref_gamma * 0.5 / 3.0

    wx = flow[..., 0]
    wy = flow[..., 1]
    w_im2, mask = warp_image(im2, wx, wy)
    d = get_derivatives(im1, w_im2)

    du = jnp.zeros_like(wx)
    dv = jnp.zeros_like(wy)
    uu = wx
    vv = wy
    for _ in range(inner_iter):
        s_horiz, s_vert = compute_smoothness(uu, vv, qa)
        a11, a12, a22, b1, b2 = data_term(mask, du, dv, d, hd3, hg3)
        b1 = sub_laplacian(b1, wx, s_horiz, s_vert)
        b2 = sub_laplacian(b2, wy, s_horiz, s_vert)
        du, dv = sor_solve(du, dv, a11, a12, a22, b1, b2, s_horiz, s_vert,
                           cfg.var_ref_iter, cfg.var_ref_sor_weight)
        uu = wx + du
        vv = wy + dv
    return jnp.stack([uu, vv], axis=-1)
