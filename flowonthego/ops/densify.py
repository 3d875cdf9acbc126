"""Patch-to-dense flow aggregation (densification) — overlap-add.

The reference scatters every patch pixel with atomicAdd into weight/flow
accumulators (src/kernels/densify.cu:54-89).  Here we exploit that patch origins are *static* (integer grid midpoints): with
the periodic split py = m*steps + pr, output row y' = (j+m)*steps + pr,
so the scatter becomes r = ceil(ps/steps) shifted adds per axis of pure
reshapes (overlap_add_canvas) — no scatter, no atomics, deterministic.

Per-pixel weight (densify.cu:75-78):
    absw = 1 / sum_c max(min_errval, cost_px[c])
accumulating (absw, absw * u, absw * v), then normalize where the weight
is positive (kernelNormalizeFlow, densify.cu:92-103).

Boundary semantics: contributions outside the image are dropped via the
padded accumulator margin (proper 2D clipping; the reference checks only
the flattened index, densify.cu:73, which wraps columns at row ends — a
1-2 px border artifact we do not reproduce).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import DISConfig
from .dis import PatchState
from .patches import PatchGrid


def _pixel_weights(state: PatchState, cfg: DISConfig) -> jax.Array:
    """absw = 1 / sum_c max(min_errval, e_c)  (densify.cu:75-78).

    e_c is the stored per-pixel error: squared residual in the default
    GPU semantics; with densify_weight="abs" (or the robust cost modes,
    which already store |d'|) it is the absolute residual, matching the
    CPU baseline (kroeger/patchgrid.cpp:254-258).
    """
    err = state.cost_px
    if cfg.densify_weight == "abs" and cfg.cost_fn == "l2":
        err = jnp.sqrt(err)
    clamped = jnp.maximum(err, cfg.min_errval)
    return 1.0 / clamped.sum(axis=-1)


def _fb_merge_scatter(state: PatchState, grid: PatchGrid, cfg: DISConfig,
                      out_h: int, out_w: int) -> jax.Array:
    """Complementary-grid merge: scatter the *reversed* backward flow.

    Equivalent of the ``cg`` branch of kroeger's AggregateFlowDense
    (kroeger/patchgrid.cpp:277-375): each complementary patch lands at its
    optimized position ``rppos = mid_org + p_cur`` (coordinates of the
    other frame); its per-pixel weights are spread bilinearly over the 4
    neighbor cells of rppos and its NEGATED flow is accumulated.  Pixels
    are kept only where all 4 cells lie inside [1, w-1) x [1, h-1).

    The positions are dynamic, so this is a genuine scatter-add — XLA's
    deterministic scatter replaces the reference's racy OpenMP loop.
    Returns a [out_h, out_w, 3] (weight, u, v) accumulator.
    """
    ps = grid.patch_size
    pos = state.mid_org + state.p_cur                 # [n_h, n_w, 2]
    px = pos[..., 0]
    py = pos[..., 1]
    cx = jnp.ceil(px + 1e-5).astype(jnp.int32)        # pos[0]
    cy = jnp.ceil(py + 1e-5).astype(jnp.int32)
    fx = jnp.floor(px)
    fy = jnp.floor(py)
    rx = (px - fx)[..., None, None]
    ry = (py - fy)[..., None, None]
    wbil = [rx * ry, (1 - rx) * ry, rx * (1 - ry), (1 - rx) * (1 - ry)]
    corner_off = [(0, 0), (1, 0), (0, 1), (1, 1)]      # (dx, dy) subtracted

    absw = _pixel_weights(state, cfg)                 # [n_h, n_w, ps, ps]
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]

    lb = -ps // 2
    dx = jnp.arange(lb, lb + ps, dtype=jnp.int32)[None, :]
    dy = jnp.arange(lb, lb + ps, dtype=jnp.int32)[:, None]
    xt = cx[..., None, None] + dx                     # [n_h, n_w, ps, ps]
    yt = cy[..., None, None] + dy
    valid = (xt >= 1) & (yt >= 1) & (xt < out_w - 1) & (yt < out_h - 1)

    acc = jnp.zeros((out_h * out_w, 3), absw.dtype)
    base = jnp.stack([absw, -u * absw, -v * absw], axis=-1)  # [...,3]
    for (ox, oy), wb in zip(corner_off, wbil):
        idx = ((yt - oy) * out_w + (xt - ox)).reshape(-1)
        vals = jnp.where(valid[..., None], wb[..., None] * base, 0.0)
        vals = vals.reshape(-1, 3)
        idx = jnp.where(valid.reshape(-1), idx, out_h * out_w)  # dropped
        acc = acc.at[idx].add(vals, mode="drop")
    return acc.reshape(out_h, out_w, 3)


def overlap_add_canvas(contrib: jax.Array, ps: int, st: int) -> jax.Array:
    """Overlap-add the [n_h, n_w, ps, ps, F] contribution grid into a
    dense canvas [(n_h+r-1)*st, (n_w+r-1)*st, F] whose (0, 0) sits at
    image position (first patch midpoint - ps/2) on each axis.

    PERIODIC reindexing, not a parity loop: splitting the in-patch pixel
    py = m*st + pr makes output row y' = (j+m)*st + pr — so the row
    overlap-add is r shifted adds of a reshape, and the column stage is r
    shifted adds of a pure reshape (no transposes at all, no stride-r
    slices).  Summation order differs from the
    parity form by association only (~1e-6 on O(1) weights).
    """
    n_h, n_w = contrib.shape[:2]
    F = contrib.shape[-1]
    r = -(-ps // st)
    R = r * st
    c = jnp.pad(contrib, ((0, 0), (0, 0), (0, R - ps), (0, R - ps),
                          (0, 0)))
    c = c.reshape(n_h, n_w, r, st, r, st, F)     # py=(m,pr), px=(q,qc)
    # Shifted adds as pad+add, NOT .at[slice].add: the latter lowers to
    # one dynamic-update-slice kernel per shift (a full read-modify-write
    # of the accumulator each, ~0.06 ms/frame across the 4K scales);
    # pad+add chains fuse into a single XLA loop.  Same summation order.
    Yp = (n_h + r - 1) * st
    rows = None
    for m in range(r):
        part = c[:, :, m].transpose(0, 2, 1, 3, 4, 5).reshape(
            n_h * st, n_w, r, st, F)
        sh = jnp.pad(part, ((m * st, Yp - m * st - n_h * st),
                            (0, 0), (0, 0), (0, 0), (0, 0)))
        rows = sh if rows is None else rows + sh
    Xp = (n_w + r - 1) * st
    cols = None
    for q in range(r):
        part = rows[:, :, q].reshape(Yp, n_w * st, F)
        sh = jnp.pad(part, ((0, 0), (q * st, Xp - q * st - n_w * st),
                            (0, 0)))
        cols = sh if cols is None else cols + sh
    return cols


def densify(state: PatchState, grid: PatchGrid, cfg: DISConfig,
            compl_state: PatchState | None = None) -> jax.Array:
    """Aggregate per-patch flow into a dense [H, W, 2] field.

    ``compl_state`` optionally merges a complementary (opposite-direction)
    grid's reversed flow — forward/backward consistency
    (kroeger/oflow.cpp usefbcon wiring).
    """
    ps, st = grid.patch_size, grid.steps
    n_h, n_w, h, w = grid.n_h, grid.n_w, grid.height, grid.width
    r = -(-ps // st)          # patches r apart in grid never overlap
    R = r * st
    margin = ps + 2 * R       # generous static margin, cropped at the end

    # Per-pixel contributions: [n_h, n_w, ps, ps, 3] = (absw, absw*u, absw*v)
    absw = _pixel_weights(state, cfg)                     # [n_h, n_w, ps, ps]
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    contrib = jnp.stack([absw, absw * u, absw * v], axis=-1)

    canvas = overlap_add_canvas(contrib, ps, st)
    Yp, Xp = canvas.shape[0], canvas.shape[1]
    top = margin + grid.offset_h - ps // 2
    left = margin + grid.offset_w - ps // 2
    assert top >= 0 and left >= 0
    assert top + Yp <= h + 2 * margin and left + Xp <= w + 2 * margin
    acc = jnp.zeros((h + 2 * margin, w + 2 * margin, 3), contrib.dtype)
    acc = acc.at[top:top + Yp, left:left + Xp, :].add(canvas)

    acc = acc[margin:margin + h, margin:margin + w, :]
    if compl_state is not None:
        acc = acc + _fb_merge_scatter(compl_state, grid, cfg, h, w)
    weight = acc[..., 0:1]
    flow = jnp.where(weight > 0, acc[..., 1:3] / weight, 0.0)
    return flow
