"""Depth-from-stereo via 1-D Dense Inverse Search.

Capability parity with the reference CPU baseline's SELECTMODE=2 build
(run_DE_* binaries, kroeger/patch.cpp:177-212,
kroeger/CMakeLists.txt:42-64): the patch parameter is a single horizontal
disparity, the Gauss-Newton system is scalar (H = sum gx^2), and after
every update the disparity is sign-clamped — <= 0 when matching into the
right image (cam_lr == 0), >= 0 into the left (patch.cpp:188-193).
Output is a dense [H, W] disparity map (saved as PFM by the CLI).

Reuses the flow engine's batched extraction/sampling/densify machinery;
differences are confined to the 1-D projection and the sign clamp.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DISConfig, operating_point, pad_to_divisible
from ..ops import dis as dis_mod
from ..ops.densify import densify
from ..ops.interp import sample_patches_bilinear
from ..ops.patches import PatchGrid, extract_templates_and_hessians
from ..ops.pyramid import build_pyramid
from ..models.dis_flow import upsample_flow_to_full


def _optimize_1d(state: dis_mod.PatchState, I1_pad, grid: PatchGrid,
                 cfg: DISConfig, cam_lr: int) -> dis_mod.PatchState:
    """Fixed-trip 1-D inverse search with disparity sign clamp."""
    # mares normalizer: values per patch, channel-generic (the config's
    # n_vals property assumes RGB; gray/gradmag inputs have C=1)
    n_vals = float(np.prod(state.templates.shape[2:]))

    active0 = ~state.converged
    diff, cost_px, cost = dis_mod._sample_residual(state, I1_pad, grid, cfg)
    diff = dis_mod._where(active0, diff, state.diff)
    cost_px = dis_mod._where(active0, cost_px, state.cost_px)
    state = state._replace(
        diff=diff, cost_px=cost_px,
        converged=state.converged | (active0 & (cost / n_vals <= cfg.res_thresh)))

    def body(_, st):
        active = ~st.converged
        dpx = (st.tgrad_x * st.diff).sum(axis=(2, 3, 4))
        delta = dpx / st.H[..., 0]          # scalar Gauss-Newton step
        d_new = st.p_cur[..., 0] - delta
        # disparity sign constraint (patch.cpp:188-193)
        d_new = jnp.minimum(d_new, 0.0) if cam_lr == 0 else jnp.maximum(d_new, 0.0)
        mid_new_x = st.mid_org[..., 0] + d_new

        disp = jnp.abs(mid_new_x - st.mid_org[..., 0])
        outlier = ((disp > cfg.outlier_thresh)
                   | (mid_new_x < grid.l_bound)
                   | (mid_new_x > grid.u_bound_w))
        d_new = jnp.where(outlier, st.p_org[..., 0], d_new)

        p_cur = jnp.stack([jnp.where(active, d_new, st.p_cur[..., 0]),
                           jnp.zeros_like(d_new)], axis=-1)
        st = st._replace(p_cur=p_cur)

        diff, cost_px, cost = dis_mod._sample_residual(st, I1_pad, grid, cfg)
        diff = dis_mod._where(active, diff, st.diff)
        cost_px = dis_mod._where(active, cost_px, st.cost_px)
        done = active & (outlier | (cost / n_vals <= cfg.res_thresh))
        return st._replace(diff=diff, cost_px=cost_px,
                           converged=st.converged | done)

    state = jax.lax.fori_loop(0, cfg.grad_descent_iter, body, state)
    return state._replace(converged=jnp.ones_like(state.converged))


def stereo_disparity_padded(I_left: jax.Array, I_right: jax.Array,
                            cfg: DISConfig, cam_lr: int = 0) -> jax.Array:
    """Dense disparity at the finest processed scale.

    cam_lr = 0: reference is the left image, disparity <= 0; 1: mirrored.
    Returns [H/2^fs, W/2^fs] disparity.
    """
    H, W = I_left.shape[0], I_left.shape[1]
    n_levels = cfg.coarsest_scale + 1
    pyr0 = build_pyramid(I_left, n_levels, cfg.padding, start_level=cfg.finest_scale)
    pyr1 = build_pyramid(I_right, n_levels, cfg.padding, start_level=cfg.finest_scale)

    flow = None
    for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        w_sl, h_sl = W >> sl, H >> sl
        grid = PatchGrid.create(cfg, w_sl, h_sl)
        lvl0, lvl1 = pyr0[sl], pyr1[sl]
        templates, gx, gy, Hs = extract_templates_and_hessians(
            lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg)
        state = dis_mod.init_state(templates, gx, gy, Hs, grid)
        if flow is not None:
            state = dis_mod.init_from_coarser(state, flow, grid)
        state = _optimize_1d(state, lvl1.image, grid, cfg, cam_lr)
        flow = densify(state, grid, cfg)
        # keep the vertical channel exactly zero between scales
        flow = flow.at[..., 1].set(0.0)

    return flow[..., 0]


@functools.partial(jax.jit, static_argnames=("cfg", "cam_lr", "orig_h",
                                             "orig_w", "pads"))
def _disparity_full_jit(I0, I1, cfg, cam_lr, orig_h, orig_w, pads):
    pt, pb, pl, pr = pads
    I0p = jnp.pad(I0, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    I1p = jnp.pad(I1, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    disp = stereo_disparity_padded(I0p, I1p, cfg, cam_lr)
    disp2 = jnp.stack([disp, jnp.zeros_like(disp)], axis=-1)
    full = upsample_flow_to_full(disp2, cfg, I0p.shape[0], I0p.shape[1])
    return jax.lax.slice(full[..., 0], (pt, pl), (pt + orig_h, pl + orig_w))


def compute_disparity(I_left, I_right, cfg: Optional[DISConfig] = None,
                      op_point: int = 2, cam_lr: int = 0) -> jax.Array:
    """End-to-end dense disparity at input resolution ([H, W])."""
    from .dis_flow import validate_image_pair
    validate_image_pair(I_left, I_right, what="stereo image")
    I_left = jnp.asarray(I_left, jnp.float32)
    I_right = jnp.asarray(I_right, jnp.float32)
    h, w = I_left.shape[0], I_left.shape[1]
    if cfg is None:
        cfg = operating_point(op_point, width=w)
        import dataclasses
        cfg = dataclasses.replace(cfg, use_var_ref=False)
    pads = pad_to_divisible(w, h, cfg.coarsest_scale)
    return _disparity_full_jit(I_left, I_right, cfg, cam_lr, h, w, pads)
