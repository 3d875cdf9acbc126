"""2-D (rows x cols) tile-sharded DIS — the full pipeline on a tile mesh.

Round 3 built the variational-refinement half of SURVEY.md §2.4's
"spatial/model axis over image tiles for 4K" (parallel/varref_tiled2d.py)
but left the DIS core row-sharded only.  This module extends EVERY
fine-scale stage to a (rows, cols) tile mesh, completing the >8-chip
single-frame latency story — at 16-64 chips row strips of a 4K frame
become too shallow for their own halos, while 2-D tiles keep the halo
perimeter small relative to the tile:

  * template extraction: 2-D edge halo of cfg.padding (ps) rows AND
    columns (two ppermutes — corners ride the lateral neighbor's row
    halo, halo.exchange_cols);
  * target sampling: I1 tile halo'd by the displacement bound + var-ref
    slack on BOTH axes; midpoints map into tile coordinates through the
    optimizer's ``sample_offset`` (now with a nonzero column component);
  * densification: parity-group overlap-add into a margin'd tile canvas,
    folded into the four neighbors with a row fold THEN a column fold —
    corner spill rides the lateral neighbor's folded rows, the exact
    scatter-inverse of the two-hop halo trick;
  * variational refinement: varref_tiled2d.variational_refine_tile
    (2-D per-sweep SOR halos);
  * coarse scales (tiles too small for their halos) fall back to the
    replicated path behind a two-axis all_gather, matching spatial_fine's
    replicate-coarse / shard-fine design.

The reference analogue of the tile grid is the whole-frame kernel grid
(src/kernels/optimize.cu:249-267): CUDA launches one
block per patch over the full frame; here the frame itself is the
distributed object and the patch grid partitions over tiles.

Bit-compatibility: every stage reproduces the unsharded math (the only
fp-order differences are gather association ulps); asserted against the
unsharded pipeline on the fake 8-device CPU mesh in
tests/test_spatial_tile2d.py for 2x4, 4x2 meshes and by dryrun_multichip.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DISConfig
from ..ops import densify as densify_mod
from ..ops import dis as dis_mod
from ..ops import variational as var_mod
from ..ops.patches import PatchGrid, extract_templates_and_hessians
from ..ops.pyramid import central_diff, downsample_half, pad_constant, \
    pad_replicate
from ..ops.resize import resize_matmul
from .halo import (exchange_accumulate_cols, exchange_accumulate_rows,
                   exchange_cols, exchange_rows)
from .spatial_fine import _halo_slack, displacement_bound
from .varref_tiled2d import COL_AXIS, ROW_AXIS, make_tile_mesh, \
    variational_refine_tile

__all__ = ["make_tile_mesh", "make_tile2d_flow",
           "make_tile2d_flow_recovering", "tiled2d_scale_levels"]


def _axis_layout(steps: int, offset: int, n_patches: int, extent: int,
                 n_shards: int):
    """Per-shard patch layout along one axis: uniform local slot count +
    per-shard start index (static numpy).  Slot k of shard i is global
    patch index (start[i] + k); slots past the range are masked invalid.
    Mirrors spatial_fine._strip_grid for either axis."""
    starts, counts = [], []
    for i in range(n_shards):
        lo, hi = i * extent, (i + 1) * extent
        j0 = max(0, math.ceil((lo - offset) / steps))
        j1 = min(n_patches, math.ceil((hi - offset) / steps))
        starts.append(j0)
        counts.append(max(0, j1 - j0))
    return (np.asarray(starts, np.int32), np.asarray(counts, np.int32),
            max(counts))


def tiled2d_scale_levels(cfg: DISConfig, H: int, W: int, n_r: int,
                         n_c: int):
    """Scales whose tile covers every halo on BOTH axes (sampling halo
    incl. var-ref slack, densification fold margin, var-ref warp halo);
    coarser scales run replicated."""
    ps, st = cfg.patch_size, cfg.steps
    r = -(-ps // st)
    densify_margin = ps + r * st
    out = []
    for sl in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        hl = (H // n_r) >> sl
        wl = (W // n_c) >> sl
        halo = (int(math.ceil(displacement_bound(cfg, sl))) + cfg.padding
                + _halo_slack(cfg))
        warp_halo = (int(math.ceil(displacement_bound(cfg, sl))) + 2
                     + _halo_slack(cfg))
        need = max(halo, densify_margin, warp_halo)
        if (min(hl, wl) >= need and (H // n_r) % (1 << sl) == 0
                and (W // n_c) % (1 << sl) == 0):
            out.append(sl)
    return out


def _extract_tile(img_halo, gx_halo, gy_halo, grid: PatchGrid, cfg,
                  row0_local, col0_local, n_loc_r: int, n_loc_c: int):
    """Templates/grads/Hessian for the n_loc_r x n_loc_c local patch
    slots.  ``*_halo``: [hl + 2*pad, wl + 2*pad, C] tiles with a 2-D halo
    of pad = cfg.padding.  row0/col0_local (traced): tile-local
    (unpadded) image coordinates of the first local patch midpoint."""
    ps, st = grid.patch_size, grid.steps
    C = img_halo.shape[2]
    pad = cfg.padding
    rows = (n_loc_r - 1) * st + ps
    cols = (n_loc_c - 1) * st + ps
    top = row0_local + pad - ps // 2
    left = col0_local + pad - ps // 2

    def windows(x):
        r = lax.dynamic_slice(x, (top, left, 0), (rows, cols, C))
        shifted = [r[a:a + (n_loc_r - 1) * st + 1:st,
                     b:b + (n_loc_c - 1) * st + 1:st, :]
                   for a in range(ps) for b in range(ps)]
        return jnp.stack(shifted, axis=2).reshape(
            n_loc_r, n_loc_c, ps, ps, C)

    templates = windows(img_halo)
    gx = windows(gx_halo)
    gy = windows(gy_halo)
    if cfg.use_mean_normalization:
        templates = templates - templates.mean(axis=(2, 3, 4), keepdims=True)
    h00 = (gx * gx).sum(axis=(2, 3, 4))
    h01 = (gx * gy).sum(axis=(2, 3, 4))
    h11 = (gy * gy).sum(axis=(2, 3, 4))
    det = h00 * h11 - h01 * h01
    bump = jnp.where(det == 0.0, 1e-10, 0.0).astype(h00.dtype)
    H = jnp.stack([h00 + bump, h01, h11 + bump], axis=-1)
    return templates, gx, gy, H


def _fb_merge_tile(state: dis_mod.PatchState, grid: PatchGrid, cfg,
                   hl: int, wl: int, margin: int, idx_r, idx_c,
                   valid) -> jax.Array:
    """2-D tile analogue of spatial_fine._fb_merge_strip (forward-backward
    consistency, kroeger/patchgrid.cpp:277-375): each local complementary
    patch scatters its NEGATED flow, bilinearly spread over the 4 cells
    of its optimized position ``mid_org + p_cur`` (global coordinates),
    into a tile canvas with ``margin`` spill on every side; the margins
    are folded into all four neighbors (rows first, then columns — the
    column fold's margins already carry the folded corner rows).

    Returns a [hl, wl, 3] (weight, u, v) accumulator to add to the
    forward accumulator before normalization.  Contributions beyond the
    margin are dropped — the caller's halo-violation counter flags the
    patches that could produce any.
    """
    ps = grid.patch_size
    w_g, h_g = grid.width, grid.height
    pos = state.mid_org + state.p_cur                  # global coords
    px = pos[..., 0]
    py = pos[..., 1]
    cx = jnp.ceil(px + 1e-5).astype(jnp.int32)
    cy = jnp.ceil(py + 1e-5).astype(jnp.int32)
    fx = jnp.floor(px)
    fy = jnp.floor(py)
    rx = (px - fx)[..., None, None]
    ry = (py - fy)[..., None, None]
    wbil = [rx * ry, (1 - rx) * ry, rx * (1 - ry), (1 - rx) * (1 - ry)]
    corner_off = [(0, 0), (1, 0), (0, 1), (1, 1)]

    absw = densify_mod._pixel_weights(state, cfg)
    absw = jnp.where(valid[..., None, None], absw, 0.0)
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    base = jnp.stack([absw, -u * absw, -v * absw], axis=-1)

    lb = -ps // 2
    dx = jnp.arange(lb, lb + ps, dtype=jnp.int32)[None, :]
    dy = jnp.arange(lb, lb + ps, dtype=jnp.int32)[:, None]
    xt = cx[..., None, None] + dx                      # global [.., ps, ps]
    yt = cy[..., None, None] + dy
    # reference validity box (global), kroeger/patchgrid.cpp:327-328
    ok = (xt >= 1) & (yt >= 1) & (xt < w_g - 1) & (yt < h_g - 1)
    # tile-local coords incl. margin offset
    yl = yt - idx_r * hl + margin
    xl = xt - idx_c * wl + margin
    rows_acc = hl + 2 * margin
    cols_acc = wl + 2 * margin

    acc = jnp.zeros((rows_acc * cols_acc, 3), base.dtype)
    for (ox, oy), wb in zip(corner_off, wbil):
        yc = yl - oy
        xc = xl - ox
        okc = (ok & (yc >= 0) & (yc < rows_acc)
               & (xc >= 0) & (xc < cols_acc))
        lin = (yc * cols_acc + xc).reshape(-1)
        vals = jnp.where(okc[..., None], wb[..., None] * base, 0.0)
        lin = jnp.where(okc.reshape(-1), lin, rows_acc * cols_acc)
        acc = acc.at[lin].add(vals.reshape(-1, 3), mode="drop")
    acc = acc.reshape(rows_acc, cols_acc, 3)
    acc = exchange_accumulate_rows(acc, margin, ROW_AXIS)
    return exchange_accumulate_cols(acc, margin, COL_AXIS)


def _densify_tile(state: dis_mod.PatchState, grid: PatchGrid, cfg,
                  hl: int, wl: int, base_row, base_col, valid,
                  compl_acc=None) -> jax.Array:
    """2-D overlap-add densification into the [hl, wl, 2] tile; margin
    spill folded into all four neighbors (rows first, then columns — the
    column fold's margins already carry the folded corner rows, the
    scatter-inverse of the exchange_rows-then-cols halo trick)."""
    ps, st = grid.patch_size, grid.steps
    n_loc_r, n_loc_c = state.converged.shape
    r = -(-ps // st)
    R = r * st
    margin = ps + R

    absw = densify_mod._pixel_weights(state, cfg)
    absw = jnp.where(valid[..., None, None], absw, 0.0)
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    contrib = jnp.stack([absw, absw * u, absw * v], axis=-1)

    # Periodic overlap-add (densify.overlap_add_canvas — no stride-r
    # slices, no per-parity transposes), then ONE dynamic placement at
    # the tile's base position.
    canvas = densify_mod.overlap_add_canvas(contrib, ps, st)
    Yp, Xp = canvas.shape[0], canvas.shape[1]
    acc = jnp.zeros((hl + 2 * margin + Yp, wl + 2 * margin + Xp, 3),
                    contrib.dtype)
    top = base_row - ps // 2 + margin
    left = base_col - ps // 2 + margin
    acc = lax.dynamic_update_slice(acc, canvas, (top, left, 0))
    acc = acc[:hl + 2 * margin, :wl + 2 * margin]
    acc = exchange_accumulate_rows(acc, margin, ROW_AXIS)
    acc = exchange_accumulate_cols(acc, margin, COL_AXIS)
    if compl_acc is not None:
        acc = acc + compl_acc
    weight = acc[..., 0:1]
    return jnp.where(weight > 0, acc[..., 1:3] / weight, 0.0)


def make_tile2d_flow(mesh: Mesh, cfg: DISConfig, H: int, W: int,
                     with_diagnostics: bool = True,
                     halo_slack: int | None = None):
    """Jitted 2-D tile-sharded flow for padded [H, W, C] frames.

    Input/output sharded P(rows, cols, None) over ``mesh``.  Fine scales
    whose tiles cover their halos run fully tiled (extraction, warm
    start, optimization, densification fold, tiled var-ref); coarser
    scales replicate behind a two-axis all_gather.  Forward-backward
    consistency (kroeger/oflow.cpp:162-170) runs fully tiled too: the
    backward grid rides the same halo machinery and its reversed-flow
    merge is a 2-D tile scatter folded into all four neighbors
    (:func:`_fb_merge_tile`).

    By default returns ``(flow, halo_violations)`` — the replicated count
    of patches whose sampling would have reached beyond the provisioned
    2-D halo (zero certifies the tiled result exact up to fp
    association; the on-device counter costs a few compares per patch
    and rides the caller's existing fetch).  ``with_diagnostics=False``
    opts out and returns the flow alone.
    """
    n_r = mesh.shape[ROW_AXIS]
    n_c = mesh.shape[COL_AXIS]
    div = 2 ** cfg.coarsest_scale
    if H % (n_r * div) or W % (n_c * div):
        raise ValueError(f"{H}x{W} must divide over the {n_r}x{n_c} tile "
                         f"mesh with 2^{cfg.coarsest_scale} divisibility")
    hl0, wl0 = H // n_r, W // n_c
    tiled_levels = set(tiled2d_scale_levels(cfg, H, W, n_r, n_c))
    pad = cfg.padding
    slack = _halo_slack(cfg) if halo_slack is None else halo_slack

    def worker(i0_tile, i1_tile):
        idx_r = lax.axis_index(ROW_AXIS)
        idx_c = lax.axis_index(COL_AXIS)
        halo_viol = jnp.int32(0)

        tiles = {0: (i0_tile, i1_tile)}
        a, b = i0_tile, i1_tile
        for sl in range(1, cfg.coarsest_scale + 1):
            a = downsample_half(a)
            b = downsample_half(b)
            tiles[sl] = (a, b)

        def gather_full(x):
            x = lax.all_gather(x, COL_AXIS, axis=1, tiled=True)
            return lax.all_gather(x, ROW_AXIS, axis=0, tiled=True)

        def halo2d(tile, halo, mode="edge"):
            x = exchange_rows(tile, halo, ROW_AXIS, mode=mode)
            return exchange_cols(x, halo, COL_AXIS, mode=mode)

        flow_tile = None
        flow_bw_tile = None   # backward chain (forward-backward consistency)
        for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
            w_sl, h_sl = W >> sl, H >> sl
            hl_sl, wl_sl = hl0 >> sl, wl0 >> sl
            grid = PatchGrid.create(cfg, w_sl, h_sl)
            s0, s1 = tiles[sl]

            if sl not in tiled_levels:
                # --- replicated fallback: gather, compute, re-slice ---
                a_full = gather_full(s0)
                b_full = gather_full(s1)

                def dis_full(src, tgt, warm_tile):
                    warm = (None if warm_tile is None
                            else gather_full(warm_tile))
                    gx0, gy0 = central_diff(src)
                    tmpl, gx, gy, Hs = extract_templates_and_hessians(
                        pad_replicate(src, pad), pad_constant(gx0, pad),
                        pad_constant(gy0, pad), grid, cfg)
                    st = dis_mod.init_state(tmpl, gx, gy, Hs, grid)
                    if warm is not None:
                        st = dis_mod.init_from_coarser(st, warm, grid)
                    return dis_mod.optimize(st, pad_replicate(tgt, pad),
                                            grid, cfg)

                st = dis_full(a_full, b_full, flow_tile)
                st_bw = None
                if cfg.use_fb_consistency:
                    st_bw = dis_full(b_full, a_full, flow_bw_tile)
                flow_full = densify_mod.densify(st, grid, cfg,
                                                compl_state=st_bw)
                bw_full = None
                if st_bw is not None and sl > cfg.finest_scale:
                    bw_full = densify_mod.densify(st_bw, grid, cfg,
                                                  compl_state=st)
                if cfg.use_var_ref:
                    flow_full = var_mod.variational_refine(
                        flow_full, a_full, b_full, cfg, sl)
                    if bw_full is not None:
                        bw_full = var_mod.variational_refine(
                            bw_full, b_full, a_full, cfg, sl)
                flow_tile = lax.dynamic_slice(
                    flow_full, (idx_r * hl_sl, idx_c * wl_sl, 0),
                    (hl_sl, wl_sl, 2))
                if bw_full is not None:
                    flow_bw_tile = lax.dynamic_slice(
                        bw_full, (idx_r * hl_sl, idx_c * wl_sl, 0),
                        (hl_sl, wl_sl, 2))
                continue

            # --- 2-D tiled scale ---
            st_px = grid.steps
            starts_r, counts_r, n_loc_r = _axis_layout(
                st_px, grid.offset_h, grid.n_h, hl_sl, n_r)
            starts_c, counts_c, n_loc_c = _axis_layout(
                st_px, grid.offset_w, grid.n_w, wl_sl, n_c)
            start_r = jnp.asarray(starts_r)[idx_r]
            start_c = jnp.asarray(starts_c)[idx_c]
            valid = ((jnp.arange(n_loc_r) < jnp.asarray(counts_r)[idx_r])
                     [:, None]
                     & (jnp.arange(n_loc_c) < jnp.asarray(counts_c)[idx_c])
                     [None, :])
            jr = start_r + jnp.arange(n_loc_r)
            jc = start_c + jnp.arange(n_loc_c)
            my = (grid.offset_h + jr * st_px).astype(jnp.float32)
            mx = (grid.offset_w + jc * st_px).astype(jnp.float32)
            mid_org = jnp.stack(
                [jnp.broadcast_to(mx[None, :], (n_loc_r, n_loc_c)),
                 jnp.broadcast_to(my[:, None], (n_loc_r, n_loc_c))],
                axis=-1)
            row0_local = grid.offset_h + start_r * st_px - idx_r * hl_sl
            col0_local = grid.offset_w + start_c * st_px - idx_c * wl_sl

            halo_t = (int(math.ceil(displacement_bound(cfg, sl))) + pad
                      + slack)

            def reach_violations(p, mask, mid_org=mid_org, grid=grid,
                                 idx_r=idx_r, idx_c=idx_c, hl_sl=hl_sl,
                                 wl_sl=wl_sl, halo_t=halo_t, valid=valid):
                ps = grid.patch_size
                rows = mid_org[..., 1] + p[..., 1]
                colsx = mid_org[..., 0] + p[..., 0]
                top = rows - ps // 2 - 1
                bot = rows + ps // 2 + 1
                lef = colsx - ps // 2 - 1
                rig = colsx + ps // 2 + 1
                lo_r = idx_r * hl_sl - (halo_t - pad)
                hi_r = (idx_r + 1) * hl_sl + (halo_t - pad)
                lo_c = idx_c * wl_sl - (halo_t - pad)
                hi_c = (idx_c + 1) * wl_sl + (halo_t - pad)
                bad = ((top < lo_r) | (bot > hi_r) | (lef < lo_c)
                       | (rig > hi_c)) & mask & valid
                return bad.sum(dtype=jnp.int32)

            def run_tile(src, tgt, warm_tile):
                """Extract from ``src`` (2-D halo'd), warm-start, optimize
                vs ``tgt``.  Gradients on the halo'd tile: halo rows/cols
                inside the image are real pixels, so central_diff there
                equals the unsharded gradient; at the global border the
                edge-replicate matches NPP replicate-border."""
                imgh = halo2d(src, pad)
                gxh, gyh = central_diff(imgh)
                row_g = (lax.broadcasted_iota(jnp.int32, gxh.shape[:1], 0)
                         - pad) + idx_r * hl_sl
                col_g = (lax.broadcasted_iota(jnp.int32, gxh.shape[1:2], 0)
                         - pad) + idx_c * wl_sl
                ok = (((row_g >= 0) & (row_g < h_sl))[:, None, None]
                      & ((col_g >= 0) & (col_g < w_sl))[None, :, None])
                gxh = jnp.where(ok, gxh, 0.0)
                gyh = jnp.where(ok, gyh, 0.0)
                tmpl, gx, gy, Hs = _extract_tile(imgh, gxh, gyh, grid, cfg,
                                                 row0_local, col0_local,
                                                 n_loc_r, n_loc_c)
                st = dis_mod.PatchState(
                    p_cur=jnp.zeros((n_loc_r, n_loc_c, 2), tmpl.dtype),
                    p_org=jnp.zeros((n_loc_r, n_loc_c, 2), tmpl.dtype),
                    mid_org=mid_org.astype(tmpl.dtype),
                    H=Hs, templates=tmpl, tgrad_x=gx, tgrad_y=gy,
                    converged=~valid,
                    cost_px=jnp.zeros_like(tmpl), diff=jnp.zeros_like(tmpl))

                if warm_tile is not None:
                    iy = (my.astype(jnp.int32) // 2) - idx_r * (hl_sl // 2)
                    ix = (mx.astype(jnp.int32) // 2) - idx_c * (wl_sl // 2)
                    p = warm_tile[
                        jnp.clip(iy, 0, warm_tile.shape[0] - 1)[:, None],
                        jnp.clip(ix, 0, warm_tile.shape[1] - 1)[None, :],
                        :] * 2.0
                    mid = st.mid_org + p
                    oob = ((mid[..., 0] < grid.l_bound)
                           | (mid[..., 1] < grid.l_bound)
                           | (mid[..., 0] > grid.u_bound_w)
                           | (mid[..., 1] > grid.u_bound_h))
                    st = st._replace(p_cur=p, p_org=p,
                                     converged=st.converged | oob)

                imgth = halo2d(tgt, halo_t)
                row_off = ((halo_t - pad) - idx_r * hl_sl).astype(tmpl.dtype)
                col_off = ((halo_t - pad) - idx_c * wl_sl).astype(tmpl.dtype)
                sample_offset = jnp.stack([col_off, row_off])
                viol = reach_violations(st.p_cur, ~st.converged)
                return dis_mod.optimize(st, imgth, grid, cfg,
                                        sample_offset=sample_offset), viol

            state, v = run_tile(s0, s1, flow_tile)
            halo_viol = halo_viol + v
            state_bw = None
            if cfg.use_fb_consistency:
                state_bw, v = run_tile(s1, s0, flow_bw_tile)
                halo_viol = halo_viol + v

            compl_acc = None
            if state_bw is not None:
                # fb scatter positions are mid_org + p_cur for every valid
                # patch (converged or not) — check their reach too
                halo_viol = (halo_viol
                             + reach_violations(
                                 state_bw.p_cur,
                                 jnp.ones_like(state_bw.converged))
                             + reach_violations(
                                 state.p_cur,
                                 jnp.ones_like(state.converged)))
                compl_acc = _fb_merge_tile(state_bw, grid, cfg, hl_sl,
                                           wl_sl, halo_t, idx_r, idx_c,
                                           valid)
            flow_tile = _densify_tile(state, grid, cfg, hl_sl, wl_sl,
                                      row0_local, col0_local, valid,
                                      compl_acc=compl_acc)
            if state_bw is not None and sl > cfg.finest_scale:
                compl_fwd = _fb_merge_tile(state, grid, cfg, hl_sl, wl_sl,
                                           halo_t, idx_r, idx_c, valid)
                flow_bw_tile = _densify_tile(state_bw, grid, cfg, hl_sl,
                                             wl_sl, row0_local, col0_local,
                                             valid, compl_acc=compl_fwd)

            if cfg.use_var_ref:
                warp_halo = (int(math.ceil(displacement_bound(cfg, sl)))
                             + 2 + slack)
                flow_tile = variational_refine_tile(
                    flow_tile, s0, s1, cfg, sl, ROW_AXIS, COL_AXIS,
                    idx_r, idx_c, hl_sl, wl_sl, h_sl, w_sl, warp_halo)
                if state_bw is not None and sl > cfg.finest_scale:
                    flow_bw_tile = variational_refine_tile(
                        flow_bw_tile, s1, s0, cfg, sl, ROW_AXIS, COL_AXIS,
                        idx_r, idx_c, hl_sl, wl_sl, h_sl, w_sl, warp_halo)

        # --- upsample the finest tile to full resolution ---
        fs = cfg.finest_scale
        if fs == 0:
            flow_out = flow_tile
        else:
            scale = float(2 ** fs)
            flow_small = gather_full(flow_tile)
            flow_out = lax.dynamic_slice(
                resize_matmul(flow_small * scale, H, W),
                (idx_r * hl0, idx_c * wl0, 0), (hl0, wl0, 2))
        if with_diagnostics:
            viol = lax.psum(lax.psum(halo_viol, ROW_AXIS), COL_AXIS)
            return flow_out, viol
        return flow_out

    out_specs = ((P(ROW_AXIS, COL_AXIS, None), P()) if with_diagnostics
                 else P(ROW_AXIS, COL_AXIS, None))
    sharded = shard_map(worker, mesh=mesh,
                        in_specs=(P(ROW_AXIS, COL_AXIS, None),) * 2,
                        out_specs=out_specs, check_vma=False)
    return jax.jit(sharded)


def make_tile2d_flow_recovering(mesh: Mesh, cfg: DISConfig, H: int, W: int,
                                halo_slack: int | None = None):
    """Tile-sharded flow with halo-violation recovery: nonzero certificate
    -> the frame is recomputed on the replicated (unsharded-math) path, so
    the API never returns silently clamped flow (see
    spatial_fine.with_replicated_recovery)."""
    from .spatial_fine import with_replicated_recovery
    sharded = make_tile2d_flow(mesh, cfg, H, W, with_diagnostics=True,
                               halo_slack=halo_slack)
    return with_replicated_recovery(sharded, cfg, H, W)
