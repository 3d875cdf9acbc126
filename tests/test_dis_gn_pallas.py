"""Persistent Gauss-Newton Pallas kernel vs the XLA loop (interpret mode).

The kernel (ops/pallas/dis_gn.gn_solve, Triton route) runs a whole
scale's solve in one launch — every iteration and the final residual;
these tests assert it reproduces ops/dis.optimize_xla with the kernel's
arithmetic run by the Pallas interpreter on the CPU.  The compiled kernel
is compared on the card by tests/test_gpu.py and chip_smoke.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from flowonthego.config import DISConfig
from flowonthego.models.dis_flow import compute_flow
from flowonthego.ops import dis as dis_mod
from flowonthego.ops.pallas import dis_gn
from flowonthego.ops.patches import PatchGrid, extract_templates_and_hessians
from flowonthego.ops.pyramid import central_diff, pad_constant, pad_replicate


def _scene(rng, h, w, shift=(2.0, 1.0), C=3):
    base = gaussian_filter(
        rng.standard_normal((h + 16, w + 16, C)).astype(np.float32),
        sigma=(4, 4, 0)) * 120 + 128
    i0 = base[8:8 + h, 8:8 + w]
    sy, sx = int(round(shift[1])), int(round(shift[0]))
    i1 = base[8 - sy:8 - sy + h, 8 - sx:8 - sx + w]
    return jnp.asarray(i0), jnp.asarray(i1)


def _problem(cfg, i0, i1, coarse_flow=None):
    h, w = i0.shape[:2]
    grid = PatchGrid.create(cfg, w, h)
    gx0, gy0 = central_diff(i0)
    tmpl, gx, gy, H = extract_templates_and_hessians(
        pad_replicate(i0, cfg.padding), pad_constant(gx0, cfg.padding),
        pad_constant(gy0, cfg.padding), grid, cfg)
    state = dis_mod.init_state(tmpl, gx, gy, H, grid)
    if coarse_flow is not None:
        state = dis_mod.init_from_coarser(state, coarse_flow, grid)
    return grid, state, pad_replicate(i1, cfg.padding)


def _optimize_both(cfg, i0, i1, coarse_flow=None):
    """One scale's solve by the XLA loop and by the kernel (interpreted)."""
    grid, state, I1p = _problem(cfg, i0, i1, coarse_flow)
    ref = dis_mod.optimize_xla(state, I1p, grid=grid, cfg=cfg)
    got = dis_mod.optimize_pallas(state, I1p, grid=grid, cfg=cfg,
                                  interpret=True)
    return ref, got


def _assert_match(ref, got, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got.p_cur), np.asarray(ref.p_cur),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(got.cost_px),
                               np.asarray(ref.cost_px), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.diff), np.asarray(ref.diff),
                               rtol=1e-3, atol=1e-3)


def test_gn_pallas_matches_xla_cold_start(rng):
    cfg = DISConfig(coarsest_scale=0, finest_scale=0)
    _assert_match(*_optimize_both(cfg, *_scene(rng, 48, 64)))


def test_gn_pallas_matches_xla_warm_start(rng):
    """Warm start exercises frozen-at-init patches and the outlier reset."""
    cfg = DISConfig(coarsest_scale=1, finest_scale=1)
    i0, i1 = _scene(rng, 48, 64, shift=(3.0, -2.0))
    coarse = jnp.asarray(
        rng.standard_normal((24, 32, 2)).astype(np.float32) * 2.0)
    _assert_match(*_optimize_both(cfg, i0, i1, coarse_flow=coarse))


@pytest.mark.parametrize("gd_iter", [0, 1, 2])
def test_gn_pallas_short_loops(rng, gd_iter):
    """gd_iter == 0 runs only the final residual; 1 and 2 add steps."""
    cfg = DISConfig(coarsest_scale=0, finest_scale=0,
                    grad_descent_iter=gd_iter)
    _assert_match(*_optimize_both(cfg, *_scene(rng, 48, 64)))


def test_gn_pallas_bf16_envelope(rng):
    """cfg.dtype="bfloat16": the kernel rounds its taps to bf16 and blends
    in f32, the XLA loop blends in bf16 — agreement is quantization-level,
    not exact."""
    i0, i1 = _scene(rng, 48, 64)
    cfg = DISConfig(coarsest_scale=0, finest_scale=0, dtype="bfloat16")
    ref, got = _optimize_both(cfg, i0, i1)
    d = np.abs(np.asarray(got.p_cur) - np.asarray(ref.p_cur))
    assert float(np.quantile(d, 0.95)) < 0.05 and float(d.max()) < 0.5, \
        f"q95={np.quantile(d, 0.95):.3g} max={d.max():.3g}"


def test_gn_pallas_full_pipeline(rng, monkeypatch):
    """End-to-end op-point-2 flow with the kernel forced on (interpreted)
    equals the XLA loop's."""
    monkeypatch.setattr(dis_mod, "optimize_pallas", functools.partial(
        dis_mod.optimize_pallas, interpret=True))
    i0, i1 = _scene(rng, 64, 96)
    cfg = DISConfig(coarsest_scale=2, finest_scale=0)
    flow_ref = np.asarray(compute_flow(
        i0, i1, dataclasses.replace(cfg, gn_backend="xla")))
    flow_pal = np.asarray(compute_flow(
        i0, i1, dataclasses.replace(cfg, gn_backend="pallas")))
    np.testing.assert_allclose(flow_pal, flow_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ps,C", [(8, 3), (8, 1), (12, 3), (12, 1)])
def test_gn_pallas_gridded_matches_single_block(rng, ps, C):
    """Patch counts that are not a multiple of the block, at both patch
    sizes and channel counts: the padded tail of the last program and the
    power-of-two pixel padding must not leak into real patches."""
    cfg = DISConfig(patch_size=ps, patch_stride=0.5, coarsest_scale=0,
                    finest_scale=0, grad_descent_iter=6)
    i0, i1 = _scene(rng, 40, 52, C=C)
    grid, state, I1p = _problem(cfg, i0, i1)
    BP = dis_gn.block_patches(dis_gn.padded_pixels(ps * ps * C))
    assert grid.n_patches % BP != 0, (grid.n_patches, BP)
    ref = dis_mod.optimize_xla(state, I1p, grid=grid, cfg=cfg)
    got = dis_mod.optimize_pallas(state, I1p, grid=grid, cfg=cfg,
                                  interpret=True)
    _assert_match(ref, got)


def test_gn_pallas_sample_offset(rng):
    """The row-sharded path samples a local strip through an integer
    offset; the kernel applies it exactly as the XLA loop does."""
    cfg = DISConfig(coarsest_scale=0, finest_scale=0, grad_descent_iter=4)
    grid, state, I1p = _problem(cfg, *_scene(rng, 48, 64))
    strip = I1p[3:]                      # the strip starts 3 rows down
    off = jnp.asarray([0, -3], jnp.int32)
    ref = dis_mod.optimize_xla(state, strip, off, grid=grid, cfg=cfg)
    got = dis_mod.optimize_pallas(state, strip, off, grid=grid, cfg=cfg,
                                  interpret=True)
    _assert_match(ref, got)


def test_gn_pallas_vmapped(rng):
    """MultiStream vmaps the pipeline over streams: the batched kernel
    equals each stream's own solve."""
    cfg = DISConfig(coarsest_scale=0, finest_scale=0, grad_descent_iter=3)
    probs = [_problem(cfg, *_scene(rng, 32, 48, shift=s))
             for s in ((1.0, 2.0), (-2.0, 1.0))]
    grid = probs[0][0]
    states = jax.tree.map(lambda *x: jnp.stack(x), *[p[1] for p in probs])
    imgs = jnp.stack([p[2] for p in probs])
    batched = jax.vmap(lambda s, i: dis_mod.optimize_pallas(
        s, i, grid=grid, cfg=cfg, interpret=True))(states, imgs)
    for b, (_, st, img) in enumerate(probs):
        one = dis_mod.optimize_xla(st, img, grid=grid, cfg=cfg)
        np.testing.assert_allclose(np.asarray(batched.p_cur[b]),
                                   np.asarray(one.p_cur), rtol=1e-4,
                                   atol=1e-4)


def test_gn_pallas_window_starts_outside_the_image(rng):
    """Warm starts that put windows past every edge of the padded image:
    the kernel's wrap-then-clamp of the window start matches the XLA
    loop's lax.dynamic_slice (the sharded path samples past its halo)."""
    cfg = DISConfig(coarsest_scale=0, finest_scale=0, grad_descent_iter=2)
    grid, state, I1p = _problem(cfg, *_scene(rng, 40, 48))
    far = jnp.asarray(rng.uniform(-30, 30, state.p_cur.shape), jnp.float32)
    state = state._replace(p_cur=far, p_org=far)
    ref = dis_mod.optimize_xla(state, I1p, grid=grid, cfg=cfg)
    got = dis_mod.optimize_pallas(state, I1p, grid=grid, cfg=cfg,
                                  interpret=True)
    _assert_match(ref, got)
