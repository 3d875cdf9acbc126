"""Forward-backward consistency merge tests (kroeger usefbcon semantics)."""

import numpy as np
import jax.numpy as jnp

from flowonthego.config import DISConfig
from flowonthego.ops.densify import densify, _fb_merge_scatter
from flowonthego.ops.dis import PatchState
from flowonthego.ops.patches import PatchGrid
from flowonthego.models.dis_flow import dis_flow_padded_jit


def _state(grid, cost_px, p_cur):
    ps = grid.patch_size
    z = jnp.zeros((grid.n_h, grid.n_w, ps, ps, 3))
    mx, my = grid.midpoints()
    mid = jnp.stack([jnp.asarray(mx), jnp.asarray(my)], -1)
    return PatchState(
        p_cur=jnp.asarray(p_cur), p_org=jnp.zeros_like(jnp.asarray(p_cur)),
        mid_org=mid, H=jnp.ones((grid.n_h, grid.n_w, 3)),
        templates=z, tgrad_x=z, tgrad_y=z,
        converged=jnp.ones((grid.n_h, grid.n_w), bool),
        cost_px=jnp.asarray(cost_px), diff=z)


def fb_oracle(grid, cfg, cost_px, p_cur, h, w):
    """Direct transcription of kroeger/patchgrid.cpp:277-375."""
    ps = grid.patch_size
    mx, my = grid.midpoints()
    we = np.zeros((h, w))
    fl = np.zeros((h, w, 2))
    for gy in range(grid.n_h):
        for gx in range(grid.n_w):
            u, v = p_cur[gy, gx]
            rx = mx[gy, gx] + u
            ry = my[gy, gx] + v
            p0 = int(np.ceil(rx + 1e-5))
            p1 = int(np.ceil(ry + 1e-5))
            r0 = rx - np.floor(rx)
            r1 = ry - np.floor(ry)
            wb = [r0 * r1, (1 - r0) * r1, r0 * (1 - r1), (1 - r0) * (1 - r1)]
            lb = -ps // 2
            for y in range(lb, lb + ps):
                for x in range(lb, lb + ps):
                    xt, yt = p0 + x, p1 + y
                    if 1 <= xt < w - 1 and 1 <= yt < h - 1:
                        c = cost_px[gy, gx, y - lb, x - lb]
                        absw = 1.0 / np.maximum(c, cfg.min_errval).sum()
                        for k, (ox, oy) in enumerate(
                                [(0, 0), (1, 0), (0, 1), (1, 1)]):
                            we[yt - oy, xt - ox] += wb[k] * absw
                            fl[yt - oy, xt - ox] -= wb[k] * absw * np.array(
                                [u, v])
    return we, fl


def test_fb_scatter_matches_oracle(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4)
    h, w = 24, 32
    grid = PatchGrid.create(cfg, w, h)
    ps = cfg.patch_size
    cost_px = (rng.random((grid.n_h, grid.n_w, ps, ps, 3)) * 8).astype(
        np.float32)
    p_cur = (1.5 * rng.standard_normal((grid.n_h, grid.n_w, 2))).astype(
        np.float32)
    state = _state(grid, cost_px, p_cur)
    acc = np.asarray(_fb_merge_scatter(state, grid, cfg, h, w))
    we, fl = fb_oracle(grid, cfg, cost_px, p_cur, h, w)
    np.testing.assert_allclose(acc[..., 0], we, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(acc[..., 1:], fl, rtol=1e-4, atol=1e-4)


def test_fb_pipeline_runs_and_stays_accurate(rng):
    from scipy.ndimage import gaussian_filter
    h, w = 64, 96
    base = gaussian_filter(
        rng.standard_normal((h + 16, w + 16, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    img0 = jnp.asarray(base[8:8 + h, 8:8 + w])
    img1 = jnp.asarray(base[6:6 + h, 5:5 + w])   # flow = (+3, +2)
    cfg = DISConfig(coarsest_scale=3, finest_scale=0, grad_descent_iter=12,
                    use_var_ref=False, use_fb_consistency=True)
    flow = np.asarray(dis_flow_padded_jit(img0, img1, cfg))
    inner = flow[8:-8, 8:-8]
    np.testing.assert_allclose(np.median(inner[..., 0]), 3.0, atol=0.1)
    np.testing.assert_allclose(np.median(inner[..., 1]), 2.0, atol=0.1)
