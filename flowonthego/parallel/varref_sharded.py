"""Row-sharded variational refinement with per-sweep SOR halo exchange.

The genuinely sequential piece of the pipeline (SURVEY.md hard part #1):
red-black SOR needs one fresh halo row per half-sweep.  Everything runs
on [hl, W] strips inside shard_map:

  * warp: backward-bilinear against an im2 strip halo'd by the flow
    displacement bound; sample rows are clamped exactly like the global
    kernel (flowUtil.cu:448-493) — global row clamp, then strip lookup;
  * derivatives: 5-tap stencils on strips halo'd by 2 rows;
  * smoothness / data / sub-Laplacian: recomputed per inner iteration
    from uu/vv strips halo'd by 2 rows (edge at global borders);
  * SOR: ``lax.ppermute`` exchange of the single boundary row of du/dv
    before every half-sweep — 2 x solve_iter x inner_iter nearest-
    neighbor transfers per scale.

Bit-compatible with ops/variational.variational_refine (equivalence
tests on the fake CPU mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import DISConfig
from ..ops.variational import (DATANORM, EPS_COLOR, EPS_GRAD, EPS_SMOOTH,
                               Derivatives, data_term)
from .halo import exchange_rows


def _global_row_mask(idx, hl: int, H: int, shape, which: str):
    """Boolean [rows, 1] mask of strip rows at the global border."""
    rows = shape[0]
    g = jax.lax.broadcasted_iota(jnp.int32, (rows, 1), 0) + idx * hl
    if which == "last":
        return g == H - 1
    return g == 0


def _deriv5_rows(x_halo2):
    """4th-order row derivative consuming a 2-row halo: [n+4,...] -> [n,...]."""
    return (8.0 * (x_halo2[3:-1] - x_halo2[1:-3])
            - (x_halo2[4:] - x_halo2[:-4])) / 12.0


def _deriv5_cols(x):
    xp = jnp.pad(x, ((0, 0), (2, 2)) + ((0, 0),) * (x.ndim - 2), mode="edge")
    return (8.0 * (xp[:, 3:-1] - xp[:, 1:-3]) - (xp[:, 4:] - xp[:, :-4])) / 12.0


def _deriv3_rows(x_halo1):
    return 0.5 * (x_halo1[2:] - x_halo1[:-2])


def _deriv3_cols(x):
    xp = jnp.pad(x, ((0, 0), (1, 1)), mode="edge")
    return 0.5 * (xp[:, 2:] - xp[:, :-2])


def warp_strip(im2_halo, wx, wy, halo: int, idx, hl: int, H: int):
    """Backward warp of a [hl, W, C] strip from an im2 strip with ``halo``
    extra rows each side.  Row clamp follows the global kernel: clamp to
    [0, H-1] globally, then to the physically available halo range."""
    h, w = wx.shape
    jj = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + idx * hl
    ii = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    xx = ii + wx
    yy = jj + wy
    x0 = jnp.floor(xx)
    y0 = jnp.floor(yy)
    dx = xx - x0
    dy = yy - y0
    mask = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < H)).astype(wx.dtype)

    x1 = jnp.clip(x0, 0, w - 1).astype(jnp.int32)
    x2 = jnp.clip(x0 + 1, 0, w - 1).astype(jnp.int32)
    base = idx * hl - halo
    y1 = jnp.clip(jnp.clip(y0, 0, H - 1).astype(jnp.int32) - base,
                  0, im2_halo.shape[0] - 1)
    y2 = jnp.clip(jnp.clip(y0 + 1, 0, H - 1).astype(jnp.int32) - base,
                  0, im2_halo.shape[0] - 1)

    dxe = dx[..., None]
    dye = dy[..., None]
    warped = (im2_halo[y1, x1] * (1 - dxe) * (1 - dye)
              + im2_halo[y1, x2] * dxe * (1 - dye)
              + im2_halo[y2, x1] * (1 - dxe) * dye
              + im2_halo[y2, x2] * dxe * dye)
    return warped, mask


def variational_refine_sharded(flow, im1, im2, cfg: DISConfig, level: int,
                               axis: str, idx, hl: int, H: int,
                               warp_halo: int):
    """Refine a [hl, W, 2] flow strip against [hl, W, C] image strips."""
    inner_iter = level + 1
    qa = 0.25 * cfg.var_ref_alpha
    hd3 = cfg.var_ref_delta * 0.5 / 3.0
    hg3 = cfg.var_ref_gamma * 0.5 / 3.0
    omega = cfg.var_ref_sor_weight

    wx = flow[..., 0]
    wy = flow[..., 1]

    # ---- warp + derivatives (once per refine) ----
    im2h = exchange_rows(im2, warp_halo, axis, mode="edge")
    w_im2, mask = warp_strip(im2h, wx, wy, warp_halo, idx, hl, H)

    def d5(x):
        xh = exchange_rows(x, 2, axis, mode="edge")
        return _deriv5_rows(xh), _deriv5_cols(x)

    mean = 0.5 * (im1 + w_im2)
    Iz = w_im2 - im1
    Iy, Ix = d5(mean)
    Ixy, Ixx = d5(Ix)
    Iyy = _deriv5_rows(exchange_rows(Iy, 2, axis, mode="edge"))
    Iyz, Ixz = d5(Iz)
    d = Derivatives(Ix=Ix, Iy=Iy, Iz=Iz, Ixx=Ixx, Ixy=Ixy, Iyy=Iyy,
                    Ixz=Ixz, Iyz=Iyz)

    last_row = _global_row_mask(idx, hl, H, wx.shape, "last")
    w = wx.shape[1]
    last_col = jax.lax.broadcasted_iota(jnp.int32, (1, w), 1) == w - 1

    def smoothness(uu, vv):
        uuh = exchange_rows(uu, 2, axis, mode="edge")
        vvh = exchange_rows(vv, 2, axis, mode="edge")
        # s on rows [-1, hl+1): compute derivs on the 1-halo band
        def band_derivs(xh):
            ux_band = _deriv3_cols(xh[1:-1])          # [hl+2, w]
            uy_band = _deriv3_rows(xh)                # [hl+2, w]
            return ux_band, uy_band
        ux, uy = band_derivs(uuh)
        vx, vy = band_derivs(vvh)
        s_band = qa / jnp.sqrt(ux * ux + uy * uy + vx * vx + vy * vy
                               + EPS_SMOOTH)          # rows [-1, hl+1)
        s = s_band[1:-1]
        s_down = s_band[2:]                            # s[j+1]
        s_up = s_band[:-2]                             # s[j-1]
        zc = jnp.zeros_like(s[:, :1])
        s_h = jnp.where(last_col, 0.0,
                        jnp.concatenate([s[:, :-1] + s[:, 1:], zc], axis=1))
        s_v = jnp.where(last_row, 0.0, s + s_down)
        # vert weight of the row above (s_v[j-1]) — from the halo band,
        # with the global-last-row zeroing applied at its position
        first_global = _global_row_mask(idx, hl, H, wx.shape, "first")
        s_v_up = jnp.where(first_global, 0.0, s_up + s)
        # s_v_up must equal s_v shifted: s_v[j-1] = s[j-1] + s[j] unless
        # j-1 is the global last row (impossible) or j == 0 globally.
        # horizontal left weight is purely local:
        zc2 = jnp.zeros_like(s_h[:, :1])
        s_h_left = jnp.concatenate([zc2, s_h[:, :-1]], axis=1)
        return s_h, s_v, s_v_up, s_h_left

    def sub_laplacian(dst, srch, s_h, s_v, s_v_up):
        """dst += weighted Laplacian; ``srch``: src with 1-row halo."""
        src = srch[1:-1]
        src_r = jnp.concatenate([src[:, 1:], src[:, -1:]], axis=1)
        ch = s_h * (src_r - src)
        zc = jnp.zeros_like(ch[:, :1])
        dst = dst + ch - jnp.concatenate([zc, ch[:, :-1]], axis=1)
        cv = s_v * (srch[2:] - src)
        cv_up = s_v_up * (src - srch[:-2])
        return dst + cv - cv_up

    du = jnp.zeros_like(wx)
    dv = jnp.zeros_like(wy)
    uu = wx
    vv = wy
    gj = jax.lax.broadcasted_iota(jnp.int32, wx.shape, 0) + idx * hl
    gi = jax.lax.broadcasted_iota(jnp.int32, wx.shape, 1)
    parity = (gi + gj) % 2

    wxh = exchange_rows(wx, 1, axis, mode="edge")
    wyh = exchange_rows(wy, 1, axis, mode="edge")

    for _ in range(inner_iter):
        s_h, s_v, s_v_up, s_h_left = smoothness(uu, vv)
        a11, a12, a22, b1, b2 = data_term(mask, du, dv, d, hd3, hg3)
        b1 = sub_laplacian(b1, wxh, s_h, s_v, s_v_up)
        b2 = sub_laplacian(b2, wyh, s_h, s_v, s_v_up)

        sum_dpsis = s_v_up + s_h_left + s_v + s_h
        A11 = a11 + sum_dpsis
        A22 = a22 + sum_dpsis

        def half_sweep(du, dv, want):
            duh = exchange_rows(du, 1, axis, mode="zero")
            dvh = exchange_rows(dv, 1, axis, mode="zero")
            def sig(xh):
                x = xh[1:-1]
                zc = jnp.zeros_like(x[:, :1])
                left = jnp.concatenate([zc, x[:, :-1]], axis=1)
                right = jnp.concatenate([x[:, 1:], zc], axis=1)
                return -(s_v_up * xh[:-2] + s_h_left * left
                         + s_v * xh[2:] + s_h * right)
            B1 = b1 - sig(duh)
            B2 = b2 - sig(dvh)
            du_new = (1.0 - omega) * du + omega / A11 * (B1 - a12 * dv)
            dv_new = (1.0 - omega) * dv + omega / A22 * (B2 - a12 * du_new)
            sel = parity == want
            return jnp.where(sel, du_new, du), jnp.where(sel, dv_new, dv)

        for _ in range(cfg.var_ref_iter):
            du, dv = half_sweep(du, dv, 1)
            du, dv = half_sweep(du, dv, 0)

        uu = wx + du
        vv = wy + dv

    return jnp.stack([uu, vv], axis=-1)
