"""Comparisons of the compiled GPU paths with their plain references.

Each function runs on JAX's default device, raises ``AssertionError``
when a comparison fails its bound, and returns the measured numbers.
``chip_smoke.py`` and the ``gpu``-marked tests call them in-process;
each bound is stated where it is checked, with its reason.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .config import operating_point, pad_to_divisible
from .models.dis_flow import compute_flow
from .ops import densify as densify_mod
from .ops import dis as dis_mod
from .ops import variational as var_mod
from .ops.patches import PatchGrid, extract_templates_and_hessians
from .ops.pyramid import build_pyramid
from .utils import synth
from .utils.metrics import average_epe

# GN kernel vs XLA loop, per scale.  The two forms agree term by term
# except for the order of the per-patch sums, so a patch's flow differs
# by float32 rounding amplified over the iterations.  The outlier reset
# is a discontinuous decision: a patch near its threshold may reset in
# one form and not the other — those are counted, not bounded.
# cost_px moves with p, so it inherits that drift: measured up to 5.7e-5
# on the card (op 2 4K, op 4 1024x436) and 1.19e-4 in interpret mode at
# op 4 on a 160x76 pair, whose smoother texture leaves smaller residuals.
GN_P_TOL = 1e-3          # px, on patches whose reset status agrees
GN_FLIP_FRAC = 1e-3      # at most 0.1% of patches flip their reset
GN_COST_RTOL = 5e-4      # |d cost_px|_1 / |cost_px|_1 on agreeing patches

# Whole-pipeline flow, GPU vs CPU (and sharded vs unsharded): the same
# outlier-reset flips, diffused by variational refinement, give a few
# px-scale outliers in an otherwise float32-rounding-level field.
# Measured on the unsharded pipeline, a 1e-4 input perturbation alone
# gives q50~2e-5, q95~2e-4, max~4e-3 px.
FLOW_Q50, FLOW_Q95, FLOW_MAX = 5e-4, 5e-3, 0.05
EPE_DELTA = 0.01         # px, |EPE(gpu) - EPE(cpu)| against ground truth


def flow_quantiles(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"q50": float(np.quantile(d, 0.5)),
            "q95": float(np.quantile(d, 0.95)), "max": float(d.max())}


def assert_flow_close(a, b, what: str) -> dict:
    q = flow_quantiles(a, b)
    assert (q["q50"] < FLOW_Q50 and q["q95"] < FLOW_Q95
            and q["max"] < FLOW_MAX), f"{what}: {q}"
    return q


def compare_gn(ref: dis_mod.PatchState, got: dis_mod.PatchState,
               p_org) -> dict:
    """Flow and cost agreement of two solves of one scale."""
    p_ref = np.asarray(ref.p_cur, np.float64)
    p_got = np.asarray(got.p_cur, np.float64)
    p0 = np.asarray(p_org, np.float64)
    reset_ref = np.all(p_ref == p0, axis=-1)
    reset_got = np.all(p_got == p0, axis=-1)
    agree = reset_ref == reset_got
    dp = np.abs(p_ref - p_got).max(axis=-1)
    c_ref = np.asarray(ref.cost_px, np.float64)[agree]
    c_got = np.asarray(got.cost_px, np.float64)[agree]
    stats = {
        "patches": int(agree.size),
        "flipped": int((~agree).sum()),
        "dp_max": float(dp[agree].max()) if agree.any() else 0.0,
        "cost_rel": float(np.abs(c_ref - c_got).sum()
                          / max(np.abs(c_ref).sum(), 1e-30)),
    }
    assert stats["flipped"] <= GN_FLIP_FRAC * agree.size, stats
    assert stats["dp_max"] <= GN_P_TOL, stats
    assert stats["cost_rel"] <= GN_COST_RTOL, stats
    return stats


def gn_kernel_vs_xla(op_point: int, h: int, w: int, seed: int = 0,
                     interpret: bool = False) -> list:
    """Run the op-point pipeline on a generated pair; at every scale solve
    the same state with the Pallas kernel and with the XLA loop and
    compare (:func:`compare_gn`).  The XLA result feeds the next scale.
    Returns one stats dict per scale."""
    cfg = operating_point(op_point, width=w)
    I0, I1, _ = synth.pair(h, w, seed)
    pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)
    pads = ((pt, pb), (pl, pr), (0, 0))
    I0 = jnp.asarray(np.pad(I0, pads, mode="edge"))
    I1 = jnp.asarray(np.pad(I1, pads, mode="edge"))
    H, W = I0.shape[:2]
    n_levels = cfg.coarsest_scale + 1
    pyr = jax.jit(lambda a: build_pyramid(a, n_levels, cfg.padding,
                                          start_level=cfg.finest_scale))
    pyr0, pyr1 = pyr(I0), pyr(I1)
    out = []
    flow = None
    for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        grid = PatchGrid.create(cfg, W >> sl, H >> sl)
        lvl0, lvl1 = pyr0[sl], pyr1[sl]

        @jax.jit
        def make_state(img, gx, gy, prev):
            st = dis_mod.init_state(*extract_templates_and_hessians(
                img, gx, gy, grid, cfg), grid)
            return st if prev is None else dis_mod.init_from_coarser(
                st, prev, grid)

        state = make_state(lvl0.image, lvl0.grad_x, lvl0.grad_y, flow)
        ref = jax.jit(lambda s, i: dis_mod.optimize_xla(
            s, i, grid=grid, cfg=cfg))(state, lvl1.image)
        got = jax.jit(lambda s, i: dis_mod.optimize_pallas(
            s, i, grid=grid, cfg=cfg, interpret=interpret))(state,
                                                             lvl1.image)
        stats = compare_gn(ref, got, state.p_org)
        stats["scale"] = sl
        out.append(stats)

        @jax.jit
        def finish(st, a, b):
            f = densify_mod.densify(st, grid, cfg)
            p = cfg.padding
            hs, ws = H >> sl, W >> sl
            if cfg.use_var_ref:
                f = var_mod.variational_refine(
                    f, a[p:p + hs, p:p + ws], b[p:p + hs, p:p + ws], cfg, sl)
            return f

        flow = finish(ref, lvl0.image, lvl1.image)
    return out


def flow_gpu_vs_cpu(op_point: int = 2, h: int = 436, w: int = 1024,
                    seed: int = 0) -> dict:
    """compute_flow on the default device and on the CPU backend of the
    same process, on one generated pair: the flip-tolerant flow check
    and the EPE of each against the ground truth."""
    I0, I1, gt = synth.pair(h, w, seed)
    cfg = operating_point(op_point, width=w)
    dev = np.asarray(compute_flow(I0, I1, cfg))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = np.asarray(compute_flow(I0, I1, cfg))
    q = assert_flow_close(dev, cpu, f"op {op_point} device vs cpu")
    epe_dev, epe_cpu = average_epe(dev, gt), average_epe(cpu, gt)
    assert abs(epe_dev - epe_cpu) < EPE_DELTA, (epe_dev, epe_cpu)
    return dict(q, epe_device=epe_dev, epe_cpu=epe_cpu)
