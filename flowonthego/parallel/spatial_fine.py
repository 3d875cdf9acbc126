"""Row-sharded DIS with halo exchange — fine scales computed in place.

Extends parallel/spatial.py (which replicates all DIS scales after one
all_gather) to genuinely shard the patch machinery of the *fine* scales
across the 'space' axis, per SURVEY.md §2.4's halo accounting:

  * template extraction needs ps/2 rows beyond the strip  -> edge halo;
  * target sampling needs the patch displacement bound — the outlier
    reset caps |p| at ps/2 at the scale it runs, and a warm start doubles
    the coarser bound, so B(sl) = ps/2 * 2^(coarsest - sl) — plus ps/2+1
    interpolation rows -> I1 halo;
  * densification writes up to ps/2 rows across the boundary -> margin
    rows folded into the neighbor with a ppermute scatter-accumulate.

A scale is sharded when its strip is tall enough for those halos
(fine scales — where the work is); coarser scales fall back to the
replicated path (one small all_gather), matching the replicate-coarse /
shard-fine design.  Variational refinement runs fully sharded with
per-sweep SOR halo exchange (parallel/varref_sharded.py).  The full
capability matrix runs sharded: forward-backward consistency (the
backward grid uses the same halo machinery; its reversed-flow merge is a
strip scatter folded into neighbors, :func:`_fb_merge_strip`), robust
costs (L1 / pseudo-Huber), and res_thresh > 0 (optimize_reference
accepts the strip sample_offset).

Every step is bit-compatible with the unsharded pipeline — asserted by
the sharded == single-device equivalence tests on the fake CPU mesh.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import DISConfig
from ..ops import densify as densify_mod
from ..ops import dis as dis_mod
from ..ops import variational as var_mod
from ..ops.patches import PatchGrid
from ..ops.pyramid import central_diff, downsample_half
from ..ops.resize import resize_rows_strip
from .halo import exchange_accumulate_rows, exchange_rows
from .mesh import SPACE_AXIS


def displacement_bound(cfg: DISConfig, sl: int) -> float:
    """Max |p| at scale sl from the DIS machinery alone: the outlier reset
    caps surviving |p| at ps/2, and a warm start doubles the coarser
    bound.  Variational refinement adds an unbounded (in theory) SOR
    increment on top; :func:`_halo_slack` budgets for it."""
    return cfg.outlier_thresh * (2.0 ** (cfg.coarsest_scale - sl))


def _halo_slack(cfg: DISConfig) -> int:
    """Extra halo rows beyond the DIS displacement bound.

    With use_var_ref the warm start is 2x a *refined* flow whose SOR
    increment is not formally bounded; in practice it stays well under a
    patch size (the data term anchors it to the DIS solution).  We budget
    2*ps rows of slack — sampling beyond the halo degrades gracefully
    (dynamic_slice clamps to the halo edge) rather than erroring."""
    return 2 * cfg.patch_size if cfg.use_var_ref else 0


def _strip_grid(cfg: DISConfig, grid: PatchGrid, hl: int, n_shards: int):
    """Per-shard patch-row layout: uniform local slot count + per-shard
    start row (numpy, static).  Slot k of shard i is global patch row
    (start[i] + k); slots past the shard's range are masked invalid."""
    st = grid.steps
    starts = []
    counts = []
    for i in range(n_shards):
        lo, hi = i * hl, (i + 1) * hl
        j0 = max(0, math.ceil((lo - grid.offset_h) / st))
        j1 = min(grid.n_h, math.ceil((hi - grid.offset_h) / st))
        starts.append(j0)
        counts.append(max(0, j1 - j0))
    n_loc = max(counts)
    return np.asarray(starts, np.int32), np.asarray(counts, np.int32), n_loc


def _extract_strip(img_halo, gx_halo, gy_halo, grid: PatchGrid, cfg,
                   row0_local, n_loc: int):
    """Templates/grads/Hessian for ``n_loc`` local patch rows.

    ``*_halo``: [hl + 2*pad, W + 2*pad, C] strip with pad = cfg.padding of
    row halo and static column padding.  ``row0_local`` (traced): image row
    (strip-local, unpadded coords) of the first local patch row's midpoint.
    """
    ps, st = grid.patch_size, grid.steps
    C = img_halo.shape[2]
    pad = cfg.padding
    rows = (n_loc - 1) * st + ps
    top = row0_local + pad - ps // 2
    left = grid.offset_w + pad - ps // 2
    cols = (grid.n_w - 1) * st + ps

    def region(x):
        return lax.dynamic_slice(x, (top, left, 0), (rows, cols, C))

    def windows(x):
        r = region(x)
        shifted = [r[a:a + (n_loc - 1) * st + 1:st,
                     b:b + (grid.n_w - 1) * st + 1:st, :]
                   for a in range(ps) for b in range(ps)]
        return jnp.stack(shifted, axis=2).reshape(n_loc, grid.n_w, ps, ps, C)

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


def _fb_merge_strip(state: dis_mod.PatchState, grid: PatchGrid, cfg,
                    hl: int, margin: int, idx, axis: str,
                    valid=None) -> jax.Array:
    """Row-sharded complementary-grid merge (forward-backward consistency).

    Strip analogue of densify._fb_merge_scatter (kroeger/patchgrid.cpp:
    277-375): each local complementary patch scatters its NEGATED flow,
    bilinearly spread over the 4 cells of its optimized position
    ``mid_org + p_cur`` (global coordinates).  The displacement from the
    patch's home row is bounded by displacement_bound + var-ref slack, so
    all contributions land within ``margin`` rows of the home strip; the
    margins are folded into the neighbors with the same ppermute
    accumulate used for the overlap-add densification.

    Returns a [hl, W, 3] (weight, u, v) accumulator to add to the
    forward accumulator before normalization.
    """
    ps = grid.patch_size
    w = grid.width
    h_global = grid.height
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
    if valid is not None:
        absw = jnp.where(valid[:, None, None, None], absw, 0.0)
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    base = jnp.stack([absw, -u * absw, -v * absw], axis=-1)

    lb = -ps // 2
    dx = jnp.arange(lb, lb + ps, dtype=jnp.int32)[None, :]
    dy = jnp.arange(lb, lb + ps, dtype=jnp.int32)[:, None]
    xt = cx[..., None, None] + dx                      # global  [.., ps, ps]
    yt = cy[..., None, None] + dy
    # reference validity box (global), kroeger/patchgrid.cpp:327-328
    ok = (xt >= 1) & (yt >= 1) & (xt < w - 1) & (yt < h_global - 1)
    # strip-local row incl. margin offset
    yl = yt - idx * hl + margin
    rows_acc = hl + 2 * margin
    ok = ok & (yl >= 0) & (yl < rows_acc)

    acc = jnp.zeros((rows_acc * w, 3), base.dtype)
    for (ox, oy), wb in zip(corner_off, wbil):
        lin = ((yl - oy) * w + (xt - ox)).reshape(-1)
        vals = jnp.where(ok[..., None], wb[..., None] * base, 0.0)
        lin = jnp.where(ok.reshape(-1), lin, rows_acc * w)   # dropped
        acc = acc.at[lin].add(vals.reshape(-1, 3), mode="drop")
    acc = acc.reshape(rows_acc, w, 3)
    return exchange_accumulate_rows(acc, margin, axis)


def _densify_strip(state: dis_mod.PatchState, grid: PatchGrid, cfg,
                   hl: int, base_row, axis: str, valid=None,
                   compl_acc=None) -> jax.Array:
    """Overlap-add densification of local patch rows into the [hl, W, 2]
    strip; boundary contributions folded into neighbors via ppermute.

    ``base_row``: strip-local image row of the first local patch row's
    midpoint (traced).  The parity overlap-add runs with static offsets in
    canvas coordinates; the canvas lands at the dynamic base offset with
    one dynamic_update_slice.

    ``compl_acc``: optional [hl, W, 3] complementary (fb-merge)
    accumulator added before normalization.
    """
    ps, st = grid.patch_size, grid.steps
    n_loc, n_w = state.converged.shape
    w = grid.width
    r = -(-ps // st)
    R = r * st
    margin = ps + R

    absw = densify_mod._pixel_weights(state, cfg)
    if valid is not None:
        # dummy padding slots (uniform local patch count) contribute nothing
        absw = jnp.where(valid[:, None, None, None], absw, 0.0)
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    contrib = jnp.stack([absw, absw * u, absw * v], axis=-1)

    # Periodic overlap-add (densify.overlap_add_canvas — no stride-r
    # slices, no per-parity transposes), then ONE dynamic placement at
    # the strip's base row.
    canvas = densify_mod.overlap_add_canvas(contrib, ps, st)
    Yp, Xp = canvas.shape[0], canvas.shape[1]
    acc = jnp.zeros((hl + 2 * margin + Yp, w + 2 * margin + Xp, 3),
                    contrib.dtype)
    top = base_row - ps // 2 + margin
    left = margin + grid.offset_w - ps // 2
    assert left >= 0
    acc = lax.dynamic_update_slice(acc, canvas, (top, left, 0))
    # crop the static canvas overhang, keep [hl + 2*margin] rows
    acc = acc[:hl + 2 * margin, :w + 2 * margin]
    acc = exchange_accumulate_rows(acc, margin, axis)
    acc = acc[:, margin:margin + w, :]
    if compl_acc is not None:
        acc = acc + compl_acc
    weight = acc[..., 0:1]
    return jnp.where(weight > 0, acc[..., 1:3] / weight, 0.0)


def sharded_scale_levels(cfg: DISConfig, H: int, n_space: int,
                         min_rows_factor: float = 1.0):
    """Which scales can run sharded: the strip must cover the target-
    sampling halo (incl. var-ref slack) AND the densification fold margin
    (ps + r*steps — exchange_accumulate_rows folds that many rows into
    each neighbor); coarser scales run replicated."""
    ps, st = cfg.patch_size, cfg.steps
    r = -(-ps // st)
    densify_margin = ps + r * st
    out = []
    for sl in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        hl_sl = (H // n_space) >> sl
        halo = (int(math.ceil(displacement_bound(cfg, sl))) + cfg.padding
                + _halo_slack(cfg))
        if hl_sl >= max(halo, densify_margin) * min_rows_factor and \
                (H // n_space) % (1 << sl) == 0:
            out.append(sl)
    return out


def make_fine_spatial_flow(mesh: Mesh, cfg: DISConfig, H: int, W: int,
                           with_diagnostics: bool = True,
                           halo_slack: int | None = None):
    """Jitted row-sharded flow for padded [H, W, C] frames with the fine
    DIS scales computed in place under halo exchange.

    Returns ``(flow, halo_violations)`` by default: full-resolution flow
    [H, W, 2] sharded over 'space', plus the (replicated) count of
    patches whose target sampling or fb scatter would have reached beyond
    the provisioned halo — i.e. where the ``_halo_slack`` budget was
    exceeded and the clamped result may differ from the unsharded
    pipeline.  Zero certifies the sharded result exact (up to fp
    association).  The counter is a handful of per-patch compares
    computed on-device — its cost is nil and it rides the caller's
    existing fetch, so production callers get the certificate for free
    instead of a silent clamp; ``with_diagnostics=False`` opts out and
    returns the flow alone.
    """
    n_space = mesh.shape[SPACE_AXIS]
    if H % (n_space * (2 ** cfg.coarsest_scale)) != 0:
        raise ValueError("H must divide over shards with 2^cs divisibility")
    hl0 = H // n_space
    sharded_levels = set(sharded_scale_levels(cfg, H, n_space))
    pad = cfg.padding
    slack = _halo_slack(cfg) if halo_slack is None else halo_slack

    def worker(i0_strip, i1_strip):
        idx = lax.axis_index(SPACE_AXIS)
        halo_viol = jnp.int32(0)   # patches sampling beyond the halo

        # --- local pyramid strips (downsample needs no halo) ---
        strips = {0: (i0_strip, i1_strip)}
        a, b = i0_strip, i1_strip
        for sl in range(1, cfg.coarsest_scale + 1):
            a = downsample_half(a)
            b = downsample_half(b)
            strips[sl] = (a, b)

        def halo_padded(strip, halo):
            """Rows via ppermute halo (edge at global borders), static
            column edge-pad -> [hl + 2*halo, W + 2*pad, C]."""
            x = exchange_rows(strip, halo, SPACE_AXIS, mode="edge")
            return jnp.pad(x, ((0, 0), (pad, pad), (0, 0)), mode="edge")

        def grads_halo(img_rows, hl_sl, w_sl, halo):
            """Gradients of the halo'd rows with global zero-pad semantics.

            img_rows: [hl + 2*halo, W, C] (row halo only).  Gradients are
            valid where neighbor rows are real; rows outside the global
            image and the column pads are zeroed (the reference zero-pads
            gradients, pyramid.cpp:122-129)."""
            gx, gy = central_diff(img_rows)
            row_g = (jax.lax.broadcasted_iota(
                jnp.int32, gx.shape[:1], 0) - halo) + idx * hl_sl
            ok = ((row_g >= 0) & (row_g < n_space * hl_sl))[:, None, None]
            gx = jnp.where(ok, gx, 0.0)
            gy = jnp.where(ok, gy, 0.0)
            gx = jnp.pad(gx, ((0, 0), (pad, pad), (0, 0)))
            gy = jnp.pad(gy, ((0, 0), (pad, pad), (0, 0)))
            return gx, gy

        flow_strip = None     # [hl_sl, W_sl, 2] at the previous (coarser) scale
        flow_bw_strip = None  # backward chain (forward-backward consistency)
        for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
            w_sl, h_sl = W >> sl, H >> sl
            hl_sl = hl0 >> sl
            grid = PatchGrid.create(cfg, w_sl, h_sl)
            s0, s1 = strips[sl]

            if sl not in sharded_levels:
                # --- replicated fallback: gather, compute, re-slice ---
                a_full = lax.all_gather(s0, SPACE_AXIS, axis=0, tiled=True)
                b_full = lax.all_gather(s1, SPACE_AXIS, axis=0, tiled=True)
                from ..ops.pyramid import pad_constant, pad_replicate
                from ..ops.patches import extract_templates_and_hessians

                def dis_full(src, tgt, warm_strip):
                    warm = None if warm_strip is None else lax.all_gather(
                        warm_strip, SPACE_AXIS, axis=0, tiled=True)
                    gx0, gy0 = central_diff(src)
                    tmpl, gx, gy, Hs = extract_templates_and_hessians(
                        pad_replicate(src, pad), pad_constant(gx0, pad),
                        pad_constant(gy0, pad), grid, cfg)
                    st = dis_mod.init_state(tmpl, gx, gy, Hs, grid)
                    if warm is not None:
                        st = dis_mod.init_from_coarser(st, warm, grid)
                    return dis_mod.optimize(st, pad_replicate(tgt, pad),
                                            grid, cfg)

                def refine_full(fl, im1, im2):
                    return var_mod.variational_refine(fl, im1, im2, cfg, sl)

                state = dis_full(a_full, b_full, flow_strip)
                state_bw = None
                if cfg.use_fb_consistency:
                    state_bw = dis_full(b_full, a_full, flow_bw_strip)
                flow_full = densify_mod.densify(state, grid, cfg,
                                                compl_state=state_bw)
                bw_full = None
                if state_bw is not None and sl > cfg.finest_scale:
                    bw_full = densify_mod.densify(state_bw, grid, cfg,
                                                  compl_state=state)
                if cfg.use_var_ref:
                    flow_full = refine_full(flow_full, a_full, b_full)
                    if bw_full is not None:
                        bw_full = refine_full(bw_full, b_full, a_full)
                flow_strip = lax.dynamic_slice(
                    flow_full, (idx * hl_sl, 0, 0), (hl_sl, w_sl, 2))
                if bw_full is not None:
                    flow_bw_strip = lax.dynamic_slice(
                        bw_full, (idx * hl_sl, 0, 0), (hl_sl, w_sl, 2))
                continue

            # --- sharded scale ---
            starts, counts, n_loc = _strip_grid(cfg, grid, hl_sl, n_space)
            starts_t = jnp.asarray(starts)[idx]
            counts_t = jnp.asarray(counts)[idx]
            slot = jnp.arange(n_loc)
            valid = slot < counts_t                       # [n_loc]
            j_global = starts_t + slot                    # global patch row
            my = (grid.offset_h + j_global * grid.steps).astype(jnp.float32)
            mx, _ = grid.midpoints()
            mid_org = jnp.stack(
                [jnp.broadcast_to(jnp.asarray(mx[0])[None, :],
                                  (n_loc, grid.n_w)),
                 jnp.broadcast_to(my[:, None], (n_loc, grid.n_w))], axis=-1)

            row0_local = (grid.offset_h + starts_t * grid.steps
                          - idx * hl_sl)

            halo_t = (int(math.ceil(displacement_bound(cfg, sl))) + pad
                      + slack)

            def row_reach_violations(p, mask):
                """Count patches whose patch rows at displacement ``p``
                reach beyond the provisioned halo_t rows around this strip
                (where sampling clamps / scatters drop — silent divergence
                from the unsharded pipeline)."""
                ps = grid.patch_size
                rows = mid_org[..., 1] + p[..., 1]       # global image rows
                top = rows - ps // 2 - 1
                bot = rows + ps // 2 + 1
                lo = idx * hl_sl - (halo_t - pad)
                hi = (idx + 1) * hl_sl + (halo_t - pad)
                bad = ((top < lo) | (bot > hi)) & mask & valid[:, None]
                return bad.sum(dtype=jnp.int32)

            def run_strip(src, tgt, warm_strip):
                """Extract from ``src``, warm-start, optimize vs ``tgt``."""
                imgh = halo_padded(src, pad)
                g = exchange_rows(src, pad, SPACE_AXIS, mode="edge")
                gx_h, gy_h = grads_halo(g, hl_sl, w_sl, pad)
                tmpl, gx, gy, Hs = _extract_strip(imgh, gx_h, gy_h, grid,
                                                  cfg, row0_local, n_loc)
                st = dis_mod.PatchState(
                    p_cur=jnp.zeros((n_loc, grid.n_w, 2), tmpl.dtype),
                    p_org=jnp.zeros((n_loc, grid.n_w, 2), tmpl.dtype),
                    mid_org=mid_org.astype(tmpl.dtype),
                    H=Hs, templates=tmpl, tgrad_x=gx, tgrad_y=gy,
                    converged=jnp.broadcast_to(~valid[:, None],
                                               (n_loc, grid.n_w)),
                    cost_px=jnp.zeros_like(tmpl), diff=jnp.zeros_like(tmpl))

                if warm_strip is not None:
                    # nearest warm start: coarse local row = my//2 - row0
                    iy = (my.astype(jnp.int32) // 2) - idx * (hl_sl // 2)
                    ix = (np.asarray(mx[0]).astype(np.int32) // 2)
                    p = warm_strip[jnp.clip(iy, 0, warm_strip.shape[0] - 1)][
                        :, ix, :] * 2.0
                    mid = st.mid_org + p
                    oob = ((mid[..., 0] < grid.l_bound)
                           | (mid[..., 1] < grid.l_bound)
                           | (mid[..., 0] > grid.u_bound_w)
                           | (mid[..., 1] > grid.u_bound_h))
                    st = st._replace(p_cur=p, p_org=p,
                                     converged=st.converged | oob)

                imgth = halo_padded(tgt, halo_t)
                # sampling happens in strip coordinates: local row 0 of
                # imgth is global padded row idx*hl_sl - (halo_t - pad);
                # bounds checks inside optimize stay in global coordinates.
                row_off = ((halo_t - pad) - idx * hl_sl).astype(tmpl.dtype)
                sample_offset = jnp.stack([jnp.zeros_like(row_off), row_off])
                # GN steps accepted by the outlier check stay within
                # outlier_thresh <= halo_t - pad of the grid row; only the
                # warm start (2x a possibly var-refined coarser flow) can
                # outrun the halo — count those.
                viol = row_reach_violations(st.p_cur, ~st.converged)
                return dis_mod.optimize(st, imgth, grid, cfg,
                                        sample_offset=sample_offset), viol

            state, v = run_strip(s0, s1, flow_strip)
            halo_viol = halo_viol + v
            state_bw = None
            if cfg.use_fb_consistency:
                state_bw, v = run_strip(s1, s0, flow_bw_strip)
                halo_viol = halo_viol + v

            compl_acc = None
            if state_bw is not None:
                # fb scatter positions are mid_org + p_cur for every valid
                # patch (converged or not) — check their reach too
                halo_viol = (halo_viol
                             + row_reach_violations(
                                 state_bw.p_cur,
                                 jnp.ones_like(state_bw.converged))
                             + row_reach_violations(
                                 state.p_cur,
                                 jnp.ones_like(state.converged)))
                compl_acc = _fb_merge_strip(state_bw, grid, cfg, hl_sl,
                                            halo_t, idx, SPACE_AXIS,
                                            valid=valid)
            flow_strip = _densify_strip(state, grid, cfg, hl_sl,
                                        row0_local, SPACE_AXIS, valid=valid,
                                        compl_acc=compl_acc)
            if state_bw is not None and sl > cfg.finest_scale:
                compl_fwd = _fb_merge_strip(state, grid, cfg, hl_sl,
                                            halo_t, idx, SPACE_AXIS,
                                            valid=valid)
                flow_bw_strip = _densify_strip(
                    state_bw, grid, cfg, hl_sl, row0_local, SPACE_AXIS,
                    valid=valid, compl_acc=compl_fwd)

            if cfg.use_var_ref:
                # fully sharded refinement: per-sweep SOR halo exchange
                from .varref_sharded import variational_refine_sharded
                warp_halo = (int(math.ceil(displacement_bound(cfg, sl)))
                             + 2 + slack)
                flow_strip = variational_refine_sharded(
                    flow_strip, s0, s1, cfg, sl, SPACE_AXIS, idx, hl_sl,
                    h_sl, warp_halo)
                if state_bw is not None and sl > cfg.finest_scale:
                    flow_bw_strip = variational_refine_sharded(
                        flow_bw_strip, s1, s0, cfg, sl, SPACE_AXIS, idx,
                        hl_sl, h_sl, warp_halo)

        # --- strip upsample to full resolution ---
        fs = cfg.finest_scale
        if fs == 0:
            flow_out = flow_strip
        else:
            scale = float(2 ** fs)
            flow_small = lax.all_gather(flow_strip, SPACE_AXIS, axis=0,
                                        tiled=True)
            flow_out = resize_rows_strip(flow_small * scale, scale, scale,
                                         lax.axis_index(SPACE_AXIS) * hl0,
                                         hl0, W)
        if with_diagnostics:
            return flow_out, lax.psum(halo_viol, SPACE_AXIS)
        return flow_out

    out_specs = (P(SPACE_AXIS), P()) if with_diagnostics else P(SPACE_AXIS)
    sharded = shard_map(worker, mesh=mesh,
                        in_specs=(P(SPACE_AXIS), P(SPACE_AXIS)),
                        out_specs=out_specs, check_vma=False)
    return jax.jit(sharded)


def make_fine_spatial_flow_recovering(mesh: Mesh, cfg: DISConfig, H: int,
                                      W: int,
                                      halo_slack: int | None = None):
    """Row-sharded flow with halo-violation RECOVERY, not just detection.

    Returns ``fn(I0, I1) -> (flow, halo_violations)``.  When the on-device
    certificate reports zero violations the sharded result is exact (up
    to fp association) and is returned as-is.  When it is nonzero — the
    warm start outran the provisioned halo and sampling was silently
    clamped — the frame is recomputed on the replicated (unsharded-math)
    path, so the API never returns clamped flow.  The counter is still
    returned so callers can monitor how often the slack budget trips.

    The replicated executable is built lazily on first violation and
    cached; a deployment that never starves its halos never compiles it.
    """
    sharded = make_fine_spatial_flow(mesh, cfg, H, W,
                                     with_diagnostics=True,
                                     halo_slack=halo_slack)
    return with_replicated_recovery(sharded, cfg, H, W)


def with_replicated_recovery(sharded_fn, cfg: DISConfig, H: int, W: int):
    """Wrap a diagnostics-returning sharded flow fn with the replicated
    fallback described in :func:`make_fine_spatial_flow_recovering`
    (shared by the row-strip and 2-D tile paths)."""
    fallback = []       # lazily-built jitted replicated path

    def fn(I0, I1):
        flow, viol = sharded_fn(I0, I1)
        if int(viol) > 0:
            if not fallback:
                from ..models.dis_flow import (dis_flow_padded,
                                               upsample_flow_to_full)

                @jax.jit
                def replicated(a, b):
                    return upsample_flow_to_full(
                        dis_flow_padded(a, b, cfg), cfg, H, W)
                fallback.append(replicated)
            flow = fallback[0](I0, I1)
        return flow, viol

    return fn
