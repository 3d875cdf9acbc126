"""Dense Inverse Search patch optimizer — the hot loop.

Replaces the reference's one-CUDA-block-per-patch persistent kernel
(src/kernels/optimize.cu:97-243) with a batched Gauss-Newton iteration
over the whole patch grid: every patch steps in lockstep with a per-patch
active mask, and the trip count is static.  Two forms compute it: the
plain XLA loop (:func:`optimize_xla`, one gather + reduction chain per
iteration) and the persistent Pallas kernel
(ops/pallas/dis_gn.py, :func:`optimize_pallas`); ops/kernels.py picks one.

Faithful semantics notes (vs optimize.cu / extract.cu):
  * The GPU port sets min_iter == max_iter == grad_descent_iter, so the
    4-clause convergence test (optimize.cu:225-233) only fires dynamically
    through ``mares <= res_thresh`` (res_thresh = 0) or the outlier reset
    (optimize.cu:66-88) — the loop is effectively fixed-trip.  We replicate
    exactly that: ``gd_iter`` projection+resample trips, with an ``active``
    mask tracking outlier-frozen patches.
  * Iteration order matches the kernel: sample at the initial midpoint
    first, then (project -> resample -> cost) x gd_iter; a patch that
    trips the outlier check still resamples once at its reset midpoint
    before freezing (the while-loop structure at optimize.cu:116-241).
  * The outlier reset restores ``p_org`` (the coarser-scale init), marks
    the patch converged, and keeps its final cost from the reset position.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DISConfig
from . import kernels
from .interp import blend_windows, gather_windows, sample_patches_bilinear
from .patches import PatchGrid

class PatchState(NamedTuple):
    """Struct-of-arrays equivalent of dev_patch_state
    (src/patch.h:15-36), shaped [n_h, n_w] (+ trailing dims).
    """
    p_cur: jax.Array       # [n_h, n_w, 2] current flow (u, v)
    p_org: jax.Array       # [n_h, n_w, 2] init flow (outlier reset target)
    mid_org: jax.Array     # [n_h, n_w, 2] grid midpoint (x, y)
    H: jax.Array           # [n_h, n_w, 3] Hessian (H00, H01, H11)
    templates: jax.Array   # [n_h, n_w, ps, ps, C] mean-normalized template
    tgrad_x: jax.Array     # [n_h, n_w, ps, ps, C] template d/dx
    tgrad_y: jax.Array     # [n_h, n_w, ps, ps, C] template d/dy
    converged: jax.Array   # [n_h, n_w] bool
    cost_px: jax.Array     # [n_h, n_w, ps, ps, C] final per-pixel sq. residual
    diff: jax.Array        # [n_h, n_w, ps, ps, C] residual (target - template)

    @property
    def mid_cur(self) -> jax.Array:
        return self.mid_org + self.p_cur


def init_state(templates, tgrad_x, tgrad_y, H, grid: PatchGrid) -> PatchState:
    """Fresh per-scale state (PatGridClass ctor init, patchgrid.cpp:124-147)."""
    mx, my = grid.midpoints()
    mid_org = jnp.stack([jnp.asarray(mx), jnp.asarray(my)], axis=-1)
    zeros2 = jnp.zeros((grid.n_h, grid.n_w, 2), templates.dtype)
    return PatchState(
        p_cur=zeros2,
        p_org=zeros2,
        mid_org=mid_org.astype(templates.dtype),
        H=H,
        templates=templates,
        tgrad_x=tgrad_x,
        tgrad_y=tgrad_y,
        converged=jnp.zeros((grid.n_h, grid.n_w), jnp.bool_),
        cost_px=jnp.zeros_like(templates),
        diff=jnp.zeros_like(templates),
    )


def init_from_coarser(state: PatchState, coarse_flow: jax.Array,
                      grid: PatchGrid) -> PatchState:
    """Warm-start from the coarser scale's dense flow.

    Mirrors kernelInitCoarserOF (extract.cu:125-164): nearest lookup at
    floor(midpoint / 2), flow scaled x2 — deliberately *not* bilinear.
    Patches whose warm-started midpoint leaves the valid box are frozen
    (converged) immediately with zero cost.

    The midpoint grid is static, so the lookup compiles to a constant-index
    gather of the [h/2, w/2, 2] coarse flow.
    """
    mx, my = grid.midpoints()
    ix = (mx.astype(int) // 2).astype(int)
    iy = (my.astype(int) // 2).astype(int)
    p = coarse_flow[iy, ix, :] * 2.0  # [n_h, n_w, 2]

    mid = state.mid_org + p
    oob = ((mid[..., 0] < grid.l_bound) | (mid[..., 1] < grid.l_bound)
           | (mid[..., 0] > grid.u_bound_w) | (mid[..., 1] > grid.u_bound_h))
    return state._replace(p_cur=p, p_org=p, converged=oob)


def _sample_residual(state: PatchState, I1_pad, grid: PatchGrid,
                     cfg: DISConfig, sample_offset=None):
    """Resample target patch at mid_cur, mean-normalize, subtract template.

    ``sample_offset`` (optional [2] integer offset, may be traced) maps
    global midpoints into the coordinate frame of ``I1_pad`` — used by the
    row-sharded path where I1_pad is a local strip.

    Returns (diff, cost_px, cost) — optimize.cu:125-209.
    """
    mid = state.mid_cur
    if sample_offset is not None:
        mid = mid + sample_offset
    raw = sample_patches_bilinear(I1_pad, mid[..., 0], mid[..., 1],
                                  grid.patch_size, grid.padding)
    if cfg.use_mean_normalization:
        raw = raw - raw.mean(axis=(2, 3, 4), keepdims=True)
    diff = raw - state.templates
    if cfg.cost_fn == "l1":
        # sign(d) * sqrt(|d|)  (kroeger/patch.cpp:240-247)
        diff = jnp.sign(diff) * jnp.sqrt(jnp.abs(diff))
        cost_px = jnp.abs(diff)
    elif cfg.cost_fn == "huber":
        # sign(d) * sqrt(2 b^2 (sqrt(1 + d^2/b^2) - 1))  (patch.cpp:248-261)
        b2 = cfg.norm_outlier * cfg.norm_outlier
        diff = jnp.sign(diff) * jnp.sqrt(
            2.0 * b2 * (jnp.sqrt(1.0 + diff * diff / b2) - 1.0))
        cost_px = jnp.abs(diff)
    else:
        cost_px = diff * diff
    cost = cost_px.sum(axis=(2, 3, 4))
    return diff, cost_px, cost


def _where(mask, a, b):
    """Broadcast a [n_h, n_w] mask over trailing dims of a/b."""
    extra = a.ndim - mask.ndim
    return jnp.where(mask.reshape(mask.shape + (1,) * extra), a, b)


def optimize_reference(state: PatchState, I1_pad: jax.Array, grid: PatchGrid,
                       cfg: DISConfig, sample_offset=None) -> PatchState:
    """Direct transcription of the reference loop (materializes the
    normalized residual tensor every iteration).  Kept as the behavior
    oracle for :func:`optimize`, and used when ``res_thresh > 0`` or the
    cost is non-quadratic (L1 / pseudo-Huber).

    ``sample_offset`` maps global midpoints into a local strip's frame
    (see :func:`_sample_residual`) so these modes also run row-sharded;
    the outlier/bounds checks stay in global coordinates.

    Equivalent of cu::interpolateAndComputeErr's in-kernel while loop
    (optimize.cu:97-243) + calcProjection (optimize.cu:23-94).
    """
    # mares normalizer: values per patch, channel-generic (the config's
    # n_vals property assumes RGB; gray/gradmag inputs have C=1)
    n_vals = float(np.prod(state.templates.shape[2:]))
    out_thresh = cfg.outlier_thresh

    # min_iter semantics (kroeger/oflow.h:37-38): below min_iter the dp/dr
    # early-exit clauses are suppressed.  None = fixed-trip GPU semantics.
    max_iter = cfg.grad_descent_iter
    min_iter = max_iter if cfg.min_iter is None else cfg.min_iter

    # --- initial resample at the warm-started midpoint (count == 0) ---
    active0 = ~state.converged
    diff, cost_px, cost = _sample_residual(state, I1_pad, grid, cfg,
                                           sample_offset)
    diff = _where(active0, diff, state.diff)
    cost_px = _where(active0, cost_px, state.cost_px)
    mares = cost / n_vals
    newly_done = active0 & (mares <= cfg.res_thresh)
    state = state._replace(diff=diff, cost_px=cost_px,
                           converged=state.converged | newly_done)
    # per-patch carries for the dp/dr clauses (patch.cpp:264-282):
    # previous-iteration mares and the first-iteration |delta_p|^2
    mares_prev = mares
    dp_init = jnp.full_like(mares, 1e-10)

    def body(i, carry):
        st, mares_prev, dp_init = carry
        cnt = i + 1                      # per-patch cnt == trip count while
        active = ~st.converged           # active (all start together)

        # --- projection: delta_p = H^-1 J^T diff (calcProjection) ---
        dpx = (st.tgrad_x * st.diff).sum(axis=(2, 3, 4))
        dpy = (st.tgrad_y * st.diff).sum(axis=(2, 3, 4))
        h00, h01, h11 = st.H[..., 0], st.H[..., 1], st.H[..., 2]
        det = h00 * h11 - h01 * h01
        delta_px = (h11 * dpx - h01 * dpy) / det
        delta_py = (h00 * dpy - h01 * dpx) / det
        delta = jnp.stack([delta_px, delta_py], axis=-1)

        p_new = st.p_cur - delta
        mid_new = st.mid_org + p_new

        # Outlier / bounds check (optimize.cu:66-88): displacement beyond
        # ps/2 or midpoint outside the valid box -> reset to p_org, freeze.
        disp = mid_new - st.mid_org
        norm = jnp.sqrt(disp[..., 0] ** 2 + disp[..., 1] ** 2)
        outlier = ((norm > out_thresh)
                   | (mid_new[..., 0] < grid.l_bound)
                   | (mid_new[..., 1] < grid.l_bound)
                   | (mid_new[..., 0] > grid.u_bound_w)
                   | (mid_new[..., 1] > grid.u_bound_h))
        p_new = _where(outlier, st.p_org, p_new)

        p_cur = _where(active, p_new, st.p_cur)
        st = st._replace(p_cur=p_cur)

        # --- resample + cost at the updated midpoint ---
        diff, cost_px, cost = _sample_residual(st, I1_pad, grid, cfg,
                                               sample_offset)
        diff = _where(active, diff, st.diff)
        cost_px = _where(active, cost_px, st.cost_px)
        mares = cost / n_vals

        # |delta_p|^2 of the solved step (pre-reset, patch.cpp:272); the
        # first iteration's value becomes the dp-ratio denominator
        dp_sq = delta_px * delta_px + delta_py * delta_py
        dp_init = jnp.where(active & (cnt == 1), dp_sq, dp_init)

        # 4-clause convergence test (patch.cpp:277-282 / optimize.cu:
        # 225-233): continue iff under max_iter, above res_thresh, and —
        # once past min_iter — the step and residual are still shrinking.
        past_min = cnt >= min_iter
        keep_going = ((cnt < max_iter) & (mares > cfg.res_thresh)
                      & (~past_min | (dp_sq / dp_init >= cfg.dp_thresh))
                      & (~past_min | (mares / mares_prev <= cfg.dr_thresh)))
        done_now = active & (outlier | ~keep_going)
        mares_prev = jnp.where(active, mares, mares_prev)
        st = st._replace(diff=diff, cost_px=cost_px,
                         converged=st.converged | done_now)
        return st, mares_prev, dp_init

    state, _, _ = jax.lax.fori_loop(0, cfg.grad_descent_iter, body,
                                    (state, mares_prev, dp_init))
    return state._replace(converged=jnp.ones_like(state.converged))


def optimize(state: PatchState, I1_pad: jax.Array, grid: PatchGrid,
             cfg: DISConfig, sample_offset=None) -> PatchState:
    """The inverse-search solve of one scale, by the form
    :func:`flowonthego.ops.kernels.gn_route` chooses for ``cfg``.

    ``sample_offset`` (optional [2] integer offset, may be traced) maps
    global midpoints into the coordinate frame of ``I1_pad`` (the
    row-sharded path's local strip)."""
    route = kernels.gn_route(cfg)
    if route == "reference":
        return optimize_reference(state, I1_pad, grid, cfg, sample_offset)
    return kernels.dispatch(
        route,
        functools.partial(optimize_pallas, grid=grid, cfg=cfg),
        functools.partial(optimize_xla, grid=grid, cfg=cfg),
        state, I1_pad, sample_offset)


def _gn_constants(state: PatchState):
    """Static per-patch sums of the reduction-form projection."""
    gx_sum = state.tgrad_x.sum(axis=(2, 3, 4))
    gy_sum = state.tgrad_y.sum(axis=(2, 3, 4))
    gxT = (state.tgrad_x * state.templates).sum(axis=(2, 3, 4))
    gyT = (state.tgrad_y * state.templates).sum(axis=(2, 3, 4))
    h00, h01, h11 = state.H[..., 0], state.H[..., 1], state.H[..., 2]
    det = h00 * h11 - h01 * h01
    return gx_sum, gy_sum, gxT, gyT, h00, h01, h11, det


def optimize_xla(state: PatchState, I1_pad: jax.Array, sample_offset=None,
                 *, grid: PatchGrid, cfg: DISConfig) -> PatchState:
    """Reduction-form Gauss-Newton loop in plain XLA.

    Mathematically equivalent to :func:`optimize_reference` (the CUDA
    kernel's semantics) but touches only the gathered (ps+1)^2 windows
    once per iteration.  The key identities, with S the mean-UNnormalized
    bilinear sample, m = sum(S)/N, T the mean-normalized template
    (sum(T) = 0), diff = (S - m) - T:

        J^T diff:  sum(g.diff) = sum(g.S) - m*sum(g) - sum(g.T)

    so the projection needs only the linear reductions [sum(S), sum(T.S),
    sum(gx.S), sum(gy.S)] — ONE batched matvec against a static per-scale
    weight stack — plus static per-patch constants.  No residual tensor
    is materialized until the final per-pixel cost for densification.

    The reference's ``mares <= res_thresh`` early exit is dropped when
    res_thresh == 0 (the default): zero residual implies a zero
    Gauss-Newton step, so continuing to iterate is a fixed point and the
    final state is identical (res_thresh > 0 takes the reference form).
    """
    ps = grid.patch_size
    n_h, n_w = state.converged.shape
    C = state.templates.shape[-1]
    N = ps * ps * C
    dtype = state.templates.dtype

    # Static per-patch weight stack [n_h, n_w, N, 4] and constants.
    ones = jnp.ones_like(state.templates)
    W4 = jnp.stack([ones, state.templates, state.tgrad_x, state.tgrad_y],
                   axis=-1).reshape(n_h, n_w, N, 4)
    # Optional bf16 sampling path: halves the window-gather and matvec
    # traffic; the reductions and all scalar state stay f32.  EPE impact
    # is sub-percent (see tests/bench); opt in with cfg.dtype="bfloat16".
    bf16 = cfg.dtype == "bfloat16"
    I1_s = I1_pad.astype(jnp.bfloat16) if bf16 else I1_pad
    W4_s = W4.astype(jnp.bfloat16) if bf16 else W4
    gx_sum, gy_sum, gxT, gyT, h00, h01, h11, det = _gn_constants(state)
    mean_on = 1.0 if cfg.use_mean_normalization else 0.0
    started = ~state.converged    # patches frozen at warm-start never sample

    def reductions(p_cur):
        """[sum S, sum T.S, sum gx.S, sum gy.S] at midpoint mid_org + p."""
        mid = state.mid_org + p_cur
        if sample_offset is not None:
            mid = mid + sample_offset
        win, rx, ry = gather_windows(I1_s, mid[..., 0], mid[..., 1],
                                     ps, grid.padding)
        if bf16:
            rx = rx.astype(jnp.bfloat16)
            ry = ry.astype(jnp.bfloat16)
        S = blend_windows(win, rx, ry).reshape(n_h, n_w, N)
        # HIGHEST: a TF32 product would round S (image values up to 255)
        # to 10 mantissa bits, an error of ~0.1 per pixel in every
        # Gauss-Newton step
        return jnp.einsum("hwk,hwki->hwi", S, W4_s,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32).astype(dtype)

    def gn_step(_, carry):
        p_cur, active = carry
        red = reductions(p_cur)
        m = red[..., 0] / N * mean_on
        dpx = red[..., 2] - m * gx_sum - gxT
        dpy = red[..., 3] - m * gy_sum - gyT
        delta_px = (h11 * dpx - h01 * dpy) / det
        delta_py = (h00 * dpy - h01 * dpx) / det
        p_new = p_cur - jnp.stack([delta_px, delta_py], axis=-1)
        mid_new = state.mid_org + p_new
        disp = mid_new - state.mid_org
        norm = jnp.sqrt(disp[..., 0] ** 2 + disp[..., 1] ** 2)
        outlier = ((norm > cfg.outlier_thresh)
                   | (mid_new[..., 0] < grid.l_bound)
                   | (mid_new[..., 1] < grid.l_bound)
                   | (mid_new[..., 0] > grid.u_bound_w)
                   | (mid_new[..., 1] > grid.u_bound_h))
        p_new = _where(outlier, state.p_org, p_new)
        p_cur = _where(active, p_new, p_cur)
        return p_cur, active & ~outlier

    p_cur, _ = jax.lax.fori_loop(0, cfg.grad_descent_iter, gn_step,
                                 (state.p_cur, started))

    # Final per-pixel cost at the final midpoint (reference computes it in
    # its last resample, optimize.cu:193-208); frozen-at-init patches keep
    # zero cost, matching the never-sampled ctor state.
    st = state._replace(p_cur=p_cur)
    diff, cost_px, _ = _sample_residual(st, I1_pad, grid, cfg, sample_offset)
    cost_px = _where(started, cost_px, jnp.zeros_like(cost_px))
    diff = _where(started, diff, jnp.zeros_like(diff))
    return st._replace(diff=diff, cost_px=cost_px,
                       converged=jnp.ones_like(state.converged))


def optimize_pallas(state: PatchState, I1_pad: jax.Array, sample_offset=None,
                    *, grid: PatchGrid, cfg: DISConfig,
                    interpret: bool = False) -> PatchState:
    """:func:`optimize_xla`'s solve as one persistent kernel launch
    (ops/pallas/dis_gn.py): packs the per-patch operands patches-minor,
    pads the patch axis to whole programs and the pixel axis to a power
    of two, and unpacks the final flow and signed residual."""
    from .pallas import dis_gn

    ps = grid.patch_size
    n_h, n_w = state.converged.shape
    C = state.templates.shape[-1]
    N = ps * ps * C
    P = n_h * n_w
    NP = dis_gn.padded_pixels(N)
    BP = dis_gn.block_patches(NP)
    Pp = -(-P // BP) * BP
    Hp, Wp = I1_pad.shape[0], I1_pad.shape[1]
    f32 = jnp.float32
    dtype = state.templates.dtype

    # tap offset of pixel (r, c, ch) from its window's top-left corner in
    # the flattened image; -1 marks the power-of-two padding
    n = np.arange(NP)
    offs = np.where(n < N, (n // (ps * C)) * Wp * C + (n // C) % ps * C
                    + n % C, -1).astype(np.int32)

    def flat(x):
        return jnp.broadcast_to(x, (n_h, n_w)).reshape(P).astype(f32)

    off = (jnp.zeros((2,), f32) if sample_offset is None
           else jnp.asarray(sample_offset).astype(f32))
    gx_sum, gy_sum, gxT, gyT, h00, h01, h11, det = _gn_constants(state)
    rows = {
        dis_gn.MID_X: state.mid_org[..., 0], dis_gn.MID_Y: state.mid_org[..., 1],
        dis_gn.OFF_X: off[0], dis_gn.OFF_Y: off[1],
        dis_gn.P_X: state.p_cur[..., 0], dis_gn.P_Y: state.p_cur[..., 1],
        dis_gn.P0_X: state.p_org[..., 0], dis_gn.P0_Y: state.p_org[..., 1],
        dis_gn.GX_SUM: gx_sum, dis_gn.GY_SUM: gy_sum,
        dis_gn.GX_T: gxT, dis_gn.GY_T: gyT,
        dis_gn.H00: h00, dis_gn.H01: h01, dis_gn.H11: h11, dis_gn.DET: det,
        dis_gn.STARTED: ~state.converged,
    }
    consts = jnp.stack([flat(rows[k]) for k in sorted(rows)])
    consts = jnp.pad(consts, ((0, dis_gn.N_CONST - len(rows)), (0, Pp - P)))
    # padding patches get det = 1 so their (discarded) steps stay finite
    consts = consts.at[dis_gn.DET, P:].set(1.0)
    w = jnp.stack([state.templates, state.tgrad_x, state.tgrad_y]).reshape(
        3, P, N).astype(f32)
    bf16 = cfg.dtype == "bfloat16"
    if bf16:
        # the XLA loop's bf16 mode reduces against a bf16 weight stack
        w = w.at[1:].set(w[1:].astype(jnp.bfloat16).astype(f32))
    w = jnp.pad(w, ((0, 0), (0, Pp - P), (0, NP - N)))

    p, diff = dis_gn.gn_solve(
        I1_pad.astype(f32).reshape(-1), jnp.asarray(offs), consts, w,
        n_iters=cfg.grad_descent_iter, ps=ps, C=C, Hp=Hp, Wp=Wp,
        padding=grid.padding, thresh=cfg.outlier_thresh,
        l_bound=grid.l_bound, ub_w=grid.u_bound_w, ub_h=grid.u_bound_h,
        mean_on=1.0 if cfg.use_mean_normalization else 0.0,
        bf16_samples=bf16, interpret=interpret)
    p_cur = p[:, :P].T.reshape(n_h, n_w, 2).astype(dtype)
    diff = diff[:P, :N].reshape(n_h, n_w, ps, ps, C).astype(dtype)
    return state._replace(p_cur=p_cur, diff=diff, cost_px=diff * diff,
                          converged=jnp.ones_like(state.converged))
