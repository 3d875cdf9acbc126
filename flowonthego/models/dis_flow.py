"""DIS optical-flow model: the coarse-to-fine orchestrator.

Equivalent of OFClass (src/oflow.cpp:38-368) and the surrounding driver
logic (src/run_dense.cpp:115-318):

    pad to 2^coarsest divisibility -> image+gradient pyramids ->
    per scale (coarse to fine):
        extract templates+Hessians -> warm start from coarser flow ->
        inverse-search optimize -> densify -> variational refinement ->
    upsample finest flow back to input resolution -> crop padding.

Differences by design (not porting artifacts):
  * Everything is one pure function of (I0, I1[, init_flow]) — jittable,
    vmappable over a frame batch, shardable with shard_map.
  * No host round-trips: the reference copies images D->H per scale for
    var-ref (oflow.cpp:327-330); here every stage consumes device arrays.
  * The Python scale loop unrolls at trace time (shapes differ per scale);
    XLA compiles the whole pipeline into one executable.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DISConfig, operating_point, pad_to_divisible
from ..ops import densify as densify_mod
from ..ops import dis as dis_mod
from ..ops import variational as var_mod
from ..ops.patches import PatchGrid, extract_templates_and_hessians
from ..ops.pyramid import build_pyramid


def dis_flow_padded(I0: jax.Array, I1: jax.Array, cfg: DISConfig,
                    init_flow: Optional[jax.Array] = None,
                    level_offset: int = 0) -> jax.Array:
    """Run the DIS pipeline on divisibility-padded images.

    I0, I1: [H, W, C] float32 with H, W divisible by 2**coarsest_scale.
    init_flow: optional warm start at half the coarsest scale's resolution
    — i.e. shape [H/2^(cs+1), W/2^(cs+1), 2] — matching the ``initflow``
    semantics of OFClass::calc (oflow.cpp:268-271).

    ``level_offset`` shifts the level index used for the variational
    inner-iteration count (inner_iter = level + 1,
    refine_variational.cpp:41) — used when a caller has pre-downsampled
    the input so scale indices here differ from the true pyramid levels.

    Returns flow [H/2^fs, W/2^fs, 2] at the finest processed scale.
    """
    H, W = I0.shape[0], I0.shape[1]
    div = 2 ** cfg.coarsest_scale
    if H % div or W % div:
        raise ValueError(f"image {H}x{W} not divisible by 2^{cfg.coarsest_scale}")

    n_levels = cfg.coarsest_scale + 1
    pyr0 = build_pyramid(I0, n_levels, cfg.padding, start_level=cfg.finest_scale)
    pyr1 = build_pyramid(I1, n_levels, cfg.padding, start_level=cfg.finest_scale)
    return dis_flow_from_pyramids(pyr0, pyr1, cfg, init_flow=init_flow,
                                  level_offset=level_offset)


def dis_flow_from_pyramids(pyr0, pyr1, cfg: DISConfig,
                           init_flow: Optional[jax.Array] = None,
                           level_offset: int = 0) -> jax.Array:
    """DIS pipeline on prebuilt pyramids (see :func:`dis_flow_padded`).

    Separated so video streaming can build each frame's pyramid ONCE and
    reuse it for two consecutive pairs (frame t is I1 of pair t-1 and I0
    of pair t) — the reference rebuilds both pyramids per pair
    (oflow.cpp:189-196), paying the dominant 4K cost twice per frame.
    """
    lvl_c = pyr0[cfg.coarsest_scale]
    H = lvl_c.image.shape[0] - 2 * cfg.padding << cfg.coarsest_scale
    W = lvl_c.image.shape[1] - 2 * cfg.padding << cfg.coarsest_scale

    def refine(flow, im1, im2, level):
        return var_mod.variational_refine(flow, im1, im2, cfg, level)

    def make_state(lvl, grid, prev_flow, warm):
        templates, gx, gy, Hs = extract_templates_and_hessians(
            lvl.image, lvl.grad_x, lvl.grad_y, grid, cfg)
        state = dis_mod.init_state(templates, gx, gy, Hs, grid)
        if prev_flow is not None:
            state = dis_mod.init_from_coarser(state, prev_flow, grid)
        elif warm is not None:
            state = dis_mod.init_from_coarser(state, warm, grid)
        return state

    flow = None
    flow_bw = None
    for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        w_sl, h_sl = W >> sl, H >> sl
        grid = PatchGrid.create(cfg, w_sl, h_sl)
        lvl0, lvl1 = pyr0[sl], pyr1[sl]

        state = make_state(lvl0, grid, flow, init_flow)
        state = dis_mod.optimize(state, lvl1.image, grid, cfg)

        # Forward-backward consistency (kroeger/oflow.cpp:190-296): the
        # complementary I1->I0 grid is optimized alongside and the two
        # densifications merge each other's reversed flow; the backward
        # chain is skipped at the finest scale where it is no longer
        # needed as a warm start.
        state_bw = None
        if cfg.use_fb_consistency:
            state_bw = make_state(lvl1, grid, flow_bw, None)
            state_bw = dis_mod.optimize(state_bw, lvl0.image, grid, cfg)

        flow = densify_mod.densify(state, grid, cfg, compl_state=state_bw)
        if state_bw is not None and sl > cfg.finest_scale:
            flow_bw = densify_mod.densify(state_bw, grid, cfg,
                                          compl_state=state)

        p = cfg.padding
        im1 = lvl0.image[p:p + h_sl, p:p + w_sl, :]
        im2 = lvl1.image[p:p + h_sl, p:p + w_sl, :]
        if cfg.use_var_ref:
            flow = refine(flow, im1, im2, sl + level_offset)
            if state_bw is not None and sl > cfg.finest_scale:
                flow_bw = refine(flow_bw, im2, im1, sl + level_offset)

    return flow


def upsample_flow_to_full(flow: jax.Array, cfg: DISConfig,
                          out_h: int, out_w: int) -> jax.Array:
    """Scale the finest-level flow to full resolution.

    flow values x2^fs then bilinear resize (half-pixel centers), matching
    ``flow_mat *= scale; cv::resize(..., INTER_LINEAR)``
    (run_dense.cpp:294-299).
    """
    s = float(2 ** cfg.finest_scale)
    if cfg.finest_scale == 0:
        return flow
    from ..ops.resize import resize_matmul
    return resize_matmul(flow * s, out_h, out_w)


# Jitted single-program form of dis_flow_padded for callers that want the
# finest-scale (non-upsampled) flow; same motivation as flow_full_padded.
dis_flow_padded_jit = functools.partial(
    jax.jit, static_argnames=("cfg",))(dis_flow_padded)


@functools.partial(jax.jit, static_argnames=("cfg",))
def flow_full_padded(I0, I1, cfg: DISConfig) -> jax.Array:
    """Jitted full-resolution flow for an already-padded pair.

    ONE compiled program for the whole multi-scale pipeline.  Running
    :func:`dis_flow_padded` eagerly instead dispatches hundreds of
    individually-jitted ops, each too small for the persistent compile
    cache's write threshold — ~10x slower end to end on CPU and paid
    again by every process (measured: 36 s eager vs 12.5 s cold-jit /
    0.1 s warm at 160x320 on the 8-device test mesh).
    """
    flow = dis_flow_padded(I0, I1, cfg)
    return upsample_flow_to_full(flow, cfg, I0.shape[0], I0.shape[1])


@functools.partial(jax.jit, static_argnames=("cfg", "orig_h", "orig_w",
                                             "pads"))
def _flow_full_jit(I0, I1, cfg: DISConfig, orig_h: int, orig_w: int, pads):
    pt, pb, pl, pr = pads
    I0p = jnp.pad(I0, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    I1p = jnp.pad(I1, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    flow = dis_flow_padded(I0p, I1p, cfg)
    flow = upsample_flow_to_full(flow, cfg, I0p.shape[0], I0p.shape[1])
    return jax.lax.slice(flow, (pt, pl, 0), (pt + orig_h, pl + orig_w, 2))


def validate_image_pair(I0, I1, what: str = "image") -> None:
    """Fail fast with a comprehensible error on malformed input pairs.

    The reference CLI exits at image load when a frame is missing or
    mismatched (run_dense.cpp:137-151); a mismatched pair fed straight to
    the jitted pipeline would instead surface as a shape error deep inside
    XLA (or silently broadcast).  One check at the API boundary.
    """
    s0, s1 = tuple(I0.shape), tuple(I1.shape)
    if len(s0) != 3:
        raise ValueError(
            f"{what} must be [H, W, C] (3-dimensional), got shape {s0}")
    if s0 != s1:
        raise ValueError(
            f"{what} pair shapes differ: {s0} vs {s1} — both frames must "
            "share height, width, and channel count")
    if s0[2] not in (1, 3):
        raise ValueError(
            f"{what} must have 1 (gray/gradmag) or 3 (RGB/BGR) channels, "
            f"got {s0[2]}; see flowonthego.ops.channels.prepare_input")
    if s0[0] < 2 or s0[1] < 2:
        raise ValueError(f"{what} too small: {s0[0]}x{s0[1]}")


def compute_flow(I0, I1, cfg: Optional[DISConfig] = None,
                 op_point: int = 2) -> jax.Array:
    """End-to-end dense flow at input resolution.

    I0, I1: [H, W, 3] float images (BGR 0..255 to mirror the reference's
    cv::imread numerics — any consistent channel convention works).
    Pads to 2^coarsest divisibility (replicate, run_dense.cpp:231-253),
    runs the pipeline, upsamples, and crops back to [H, W, 2].
    """
    validate_image_pair(I0, I1)
    I0 = jnp.asarray(I0, jnp.float32)
    I1 = jnp.asarray(I1, jnp.float32)
    h, w = I0.shape[0], I0.shape[1]
    if cfg is None:
        cfg = operating_point(op_point, width=w)
    pads = pad_to_divisible(w, h, cfg.coarsest_scale)
    return _flow_full_jit(I0, I1, cfg, h, w, pads)


def compute_flow_timed(I0, I1, cfg: Optional[DISConfig] = None,
                       op_point: int = 2, printer=print) -> jax.Array:
    """Verbosity-2 diagnostic run: per-scale phase timing.

    Prints the reference's canonical per-scale line
    ``TIME (Sc: %i, #p:%6i, pconst, pinit, poptim, cflow, tvopt, total)``
    (src/oflow.cpp:346) plus the per-phase aggregate
    totals of PatGridClass::printTimings (src/patchgrid.cpp:334-345).

    Runs the same ops as :func:`dis_flow_padded` but phase-by-phase with a
    device sync between phases, so it is a profiling mode: phase costs are
    honest, the total carries sync overhead the fused jit path does not.
    Returns the full-resolution flow like :func:`compute_flow`.
    """
    import time as _time

    from ..utils.timing import PhaseTimer

    I0 = jnp.asarray(I0, jnp.float32)
    I1 = jnp.asarray(I1, jnp.float32)
    h, w = I0.shape[0], I0.shape[1]
    if cfg is None:
        cfg = operating_point(op_point, width=w)
    pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)
    I0p = jnp.pad(I0, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    I1p = jnp.pad(I1, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    H, W = I0p.shape[0], I0p.shape[1]

    timer = PhaseTimer()

    t_all = _time.perf_counter()
    with timer.phase("pyramid") as out:
        n_levels = cfg.coarsest_scale + 1
        pyr0 = build_pyramid(I0p, n_levels, cfg.padding,
                             start_level=cfg.finest_scale)
        pyr1 = build_pyramid(I1p, n_levels, cfg.padding,
                             start_level=cfg.finest_scale)
        out += [pyr0, pyr1]
    printer(f"TIME (Pyramide+Gradients) (ms): "
            f"{timer.totals['pyramid']:.3f}")

    def ms_since(t0, *outputs):
        """Milliseconds since ``t0`` once ``outputs`` are on the device."""
        jax.block_until_ready(outputs)
        return (_time.perf_counter() - t0) * 1000.0

    flow = None
    flow_bw = None
    for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        w_sl, h_sl = W >> sl, H >> sl
        grid = PatchGrid.create(cfg, w_sl, h_sl)
        lvl0, lvl1 = pyr0[sl], pyr1[sl]
        t_scale = _time.perf_counter()

        with timer.phase("extract") as out:
            t0 = _time.perf_counter()
            templates, gx, gy, Hs = extract_templates_and_hessians(
                lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg)
            state = dis_mod.init_state(templates, gx, gy, Hs, grid)
            state_bw = None
            if cfg.use_fb_consistency:
                tb, gxb, gyb, Hb = extract_templates_and_hessians(
                    lvl1.image, lvl1.grad_x, lvl1.grad_y, grid, cfg)
                state_bw = dis_mod.init_state(tb, gxb, gyb, Hb, grid)
            out += [state, state_bw]
            pconst = ms_since(t0, *out)
        with timer.phase("coarse") as out:
            t0 = _time.perf_counter()
            if flow is not None:
                state = dis_mod.init_from_coarser(state, flow, grid)
            if state_bw is not None and flow_bw is not None:
                state_bw = dis_mod.init_from_coarser(state_bw, flow_bw, grid)
            out += [state, state_bw]
            pinit = ms_since(t0, *out)
        with timer.phase("opti") as out:
            t0 = _time.perf_counter()
            state = dis_mod.optimize(state, lvl1.image, grid, cfg)
            if state_bw is not None:
                state_bw = dis_mod.optimize(state_bw, lvl0.image, grid, cfg)
            out += [state, state_bw]
            poptim = ms_since(t0, *out)
        with timer.phase("aggregate") as out:
            t0 = _time.perf_counter()
            flow = densify_mod.densify(state, grid, cfg,
                                       compl_state=state_bw)
            if state_bw is not None and sl > cfg.finest_scale:
                flow_bw = densify_mod.densify(state_bw, grid, cfg,
                                              compl_state=state)
            out += [flow, flow_bw]
            cflow = ms_since(t0, *out)
        tvopt = 0.0
        if cfg.use_var_ref:
            with timer.phase("var_ref") as out:
                t0 = _time.perf_counter()
                p = cfg.padding
                im1 = lvl0.image[p:p + h_sl, p:p + w_sl, :]
                im2 = lvl1.image[p:p + h_sl, p:p + w_sl, :]
                refine_fn = var_mod.variational_refine
                flow = refine_fn(flow, im1, im2, cfg, sl)
                if state_bw is not None and sl > cfg.finest_scale:
                    flow_bw = refine_fn(flow_bw, im2, im1, cfg, sl)
                out += [flow, flow_bw]
                tvopt = ms_since(t0, *out)
        total = (_time.perf_counter() - t_scale) * 1000.0
        printer(f"TIME (Sc: {sl}, #p:{grid.n_patches:6d}, pconst, pinit, "
                f"poptim, cflow, tvopt, total): {pconst:8.2f} {pinit:8.2f} "
                f"{poptim:8.2f} {cflow:8.2f} {tvopt:8.2f} -> "
                f"{total:8.2f} ms.")

    with timer.phase("upsample") as out:
        flow = upsample_flow_to_full(flow, cfg, H, W)
        flow = jax.lax.slice(flow, (pt, pl, 0), (pt + h, pl + w, 2))
        out.append(flow)
    printer(f"TIME (O.Flow Run-Time   ) (ms): "
            f"{(_time.perf_counter() - t_all) * 1000.0:.3f}")
    printer(timer.report())
    return flow


class DISFlow:
    """Object-style API mirroring OFClass: configure once, ``calc`` many.

    Unlike the reference (which mutates per-scale device buffers), this is
    a thin stateless wrapper holding only the config; ``calc`` is a cached
    jitted call per input shape.
    """

    def __init__(self, cfg: Optional[DISConfig] = None, op_point: int = 2):
        self.cfg = cfg
        self.op_point = op_point

    def config_for(self, width: int) -> DISConfig:
        return self.cfg if self.cfg is not None else operating_point(
            self.op_point, width=width)

    def calc(self, I0, I1) -> np.ndarray:
        """Compute flow for one frame pair; returns numpy [H, W, 2]."""
        out = compute_flow(I0, I1, cfg=self.cfg, op_point=self.op_point)
        return np.asarray(out)
