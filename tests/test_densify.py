"""Overlap-add densification vs a naive numpy scatter oracle
(semantics of src/kernels/densify.cu:54-103, with proper 2D clipping)."""

import numpy as np
import jax.numpy as jnp

from flowonthego.config import DISConfig
from flowonthego.ops.densify import densify
from flowonthego.ops.dis import PatchState, init_state
from flowonthego.ops.patches import PatchGrid


def naive_densify(grid, cost_px, p_cur, min_errval):
    h, w, ps = grid.height, grid.width, grid.patch_size
    weights = np.zeros((h, w), np.float64)
    flow = np.zeros((h, w, 2), np.float64)
    mx, my = grid.midpoints()
    for gy in range(grid.n_h):
        for gx in range(grid.n_w):
            x0 = int(mx[gy, gx]) - ps // 2
            y0 = int(my[gy, gx]) - ps // 2
            for r in range(ps):
                for c in range(ps):
                    y, x = y0 + r, x0 + c
                    if 0 <= y < h and 0 <= x < w:
                        absw = 1.0 / np.maximum(
                            cost_px[gy, gx, r, c], min_errval).sum()
                        weights[y, x] += absw
                        flow[y, x] += absw * p_cur[gy, gx]
    out = np.zeros_like(flow)
    nz = weights > 0
    out[nz] = flow[nz] / weights[nz, None]
    return out


def _make_state(grid, cost_px, p_cur):
    ps = grid.patch_size
    z = jnp.zeros((grid.n_h, grid.n_w, ps, ps, 3))
    return PatchState(
        p_cur=jnp.asarray(p_cur), p_org=jnp.zeros_like(jnp.asarray(p_cur)),
        mid_org=jnp.zeros((grid.n_h, grid.n_w, 2)),
        H=jnp.ones((grid.n_h, grid.n_w, 3)),
        templates=z, tgrad_x=z, tgrad_y=z,
        converged=jnp.ones((grid.n_h, grid.n_w), bool),
        cost_px=jnp.asarray(cost_px), diff=z)


def _check(cfg, h, w, rng):
    grid = PatchGrid.create(cfg, w, h)
    ps = cfg.patch_size
    cost_px = (rng.random((grid.n_h, grid.n_w, ps, ps, 3)) * 10).astype(
        np.float32)
    p_cur = rng.standard_normal((grid.n_h, grid.n_w, 2)).astype(np.float32)
    state = _make_state(grid, cost_px, p_cur)
    out = np.asarray(densify(state, grid, cfg))
    ref = naive_densify(grid, cost_px, p_cur, cfg.min_errval)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_densify_op2_geometry(rng):
    _check(DISConfig(patch_size=8, patch_stride=0.4), 24, 32, rng)


def test_densify_op1_geometry(rng):
    # steps=5, ps=8: blocks need zero-padding to the parity pitch
    _check(DISConfig(patch_size=8, patch_stride=0.3), 25, 30, rng)


def test_densify_op3_geometry(rng):
    # ps=12, steps=3: r=4 parity groups
    _check(DISConfig(patch_size=12, patch_stride=0.75), 27, 36, rng)


def test_abs_weight_mode_matches_cpu_formula(rng):
    """densify_weight='abs' uses 1/sum max(minerr, |d|) (CPU baseline)."""
    import dataclasses
    cfg = dataclasses.replace(DISConfig(patch_size=8, patch_stride=0.4),
                              densify_weight="abs")
    h, w = 16, 24
    grid = PatchGrid.create(cfg, w, h)
    ps = cfg.patch_size
    # cost_px stores squared residuals in l2 mode; abs mode sqrt()s them
    diffs = rng.random((grid.n_h, grid.n_w, ps, ps, 3)).astype(np.float32) * 6
    cost_px = diffs * diffs
    p_cur = rng.standard_normal((grid.n_h, grid.n_w, 2)).astype(np.float32)
    out = np.asarray(densify(_make_state(grid, cost_px, p_cur), grid, cfg))
    ref = naive_densify(grid, np.abs(diffs), p_cur, cfg.min_errval)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_every_pixel_covered(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4)
    h, w = 16, 24
    grid = PatchGrid.create(cfg, w, h)
    ps = cfg.patch_size
    cost_px = np.zeros((grid.n_h, grid.n_w, ps, ps, 3), np.float32)
    p_cur = np.ones((grid.n_h, grid.n_w, 2), np.float32)
    out = np.asarray(densify(_make_state(grid, cost_px, p_cur), grid, cfg))
    # constant unit flow from every patch -> exactly 1 everywhere
    np.testing.assert_allclose(out, 1.0, rtol=1e-6)
