"""Fast reduction-form optimizer vs the reference-form loop.

The two paths must produce (numerically) identical flows — the algebraic
restructuring in ops/dis.py::optimize is exact up to float re-association.
"""

import numpy as np
import jax.numpy as jnp

from flowonthego.config import DISConfig


def _jit_optimize(state, I1, grid, cfg):
    """One compiled program per scale-solve instead of eager op-by-op
    dispatch (each eager op is too small for the persistent compile
    cache; the jitted form is cached across processes)."""
    import jax
    return jax.jit(lambda st, im: dis_mod.optimize(st, im, grid, cfg))(
        state, I1)

from flowonthego.ops import dis as dis_mod
from flowonthego.ops.patches import PatchGrid, extract_templates_and_hessians
from flowonthego.ops.pyramid import pad_replicate, pad_constant, central_diff


def _setup(img0, img1, cfg):
    h, w = img0.shape[:2]
    grid = PatchGrid.create(cfg, w, h)
    gx0, gy0 = central_diff(jnp.asarray(img0))
    pad = cfg.padding
    I0 = pad_replicate(jnp.asarray(img0), pad)
    I0x = pad_constant(gx0, pad)
    I0y = pad_constant(gy0, pad)
    I1 = pad_replicate(jnp.asarray(img1), pad)
    tmpl, tgx, tgy, H = extract_templates_and_hessians(I0, I0x, I0y, grid, cfg)
    return dis_mod.init_state(tmpl, tgx, tgy, H, grid), I1, grid


def _images(rng, h, w):
    from scipy.ndimage import gaussian_filter
    base = gaussian_filter(
        rng.standard_normal((h + 8, w + 8, 3)).astype(np.float32),
        sigma=(2, 2, 0)) * 80 + 128
    return base[4:4 + h, 4:4 + w], base[2:2 + h, 3:3 + w]


def test_fast_matches_reference_zero_init(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12)
    img0, img1 = _images(rng, 40, 56)
    state, I1, grid = _setup(img0, img1, cfg)

    ref = dis_mod.optimize_reference(state, I1, grid, cfg)
    fast = _jit_optimize(state, I1, grid, cfg)

    np.testing.assert_allclose(np.asarray(fast.p_cur), np.asarray(ref.p_cur),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(fast.cost_px),
                               np.asarray(ref.cost_px), rtol=1e-2, atol=0.5)


def test_fast_matches_reference_coarse_init(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12)
    img0, img1 = _images(rng, 32, 48)
    state, I1, grid = _setup(img0, img1, cfg)
    coarse = 0.5 * rng.standard_normal((16, 24, 2)).astype(np.float32)
    coarse[1, :] = 50.0   # row read by the first patch row -> frozen at init
    state = dis_mod.init_from_coarser(state, jnp.asarray(coarse), grid)

    ref = dis_mod.optimize_reference(state, I1, grid, cfg)
    fast = _jit_optimize(state, I1, grid, cfg)

    np.testing.assert_allclose(np.asarray(fast.p_cur), np.asarray(ref.p_cur),
                               rtol=1e-3, atol=2e-3)
    # frozen-at-init patches keep zero cost in both paths
    frozen = np.asarray(state.converged)
    assert frozen.any()
    assert (np.asarray(fast.cost_px)[frozen] == 0).all()
    assert (np.asarray(ref.cost_px)[frozen] == 0).all()


def test_fast_mean_norm_off(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=8,
                    use_mean_normalization=False)
    img0, img1 = _images(rng, 32, 32)
    state, I1, grid = _setup(img0, img1, cfg)
    ref = dis_mod.optimize_reference(state, I1, grid, cfg)
    fast = _jit_optimize(state, I1, grid, cfg)
    np.testing.assert_allclose(np.asarray(fast.p_cur), np.asarray(ref.p_cur),
                               rtol=1e-3, atol=2e-3)


def test_min_iter_none_equals_fixed_trip(rng):
    """min_iter=None (fixed-trip GPU semantics) == min_iter=max_iter."""
    import dataclasses
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12)
    img0, img1 = _images(rng, 40, 56)
    state, I1, grid = _setup(img0, img1, cfg)
    a = dis_mod.optimize_reference(state, I1, grid, cfg)
    cfg_b = dataclasses.replace(cfg, min_iter=12)
    b = dis_mod.optimize_reference(state, I1, grid, cfg_b)
    np.testing.assert_array_equal(np.asarray(a.p_cur), np.asarray(b.p_cur))


def test_min_iter_dp_clause_stops_after_first_iter(rng):
    """With min_iter=1 and an impossible dp_thresh, every patch exits at
    count 1 — identical to running a single GD iteration
    (kroeger/patch.cpp:279-282 semantics)."""
    import dataclasses
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12,
                    min_iter=1, dp_thresh=1e10)
    img0, img1 = _images(rng, 40, 56)
    state, I1, grid = _setup(img0, img1, cfg)
    early = _jit_optimize(state, I1, grid, cfg)
    cfg_one = dataclasses.replace(cfg, grad_descent_iter=1, min_iter=None,
                                  dp_thresh=0.0025)
    one = dis_mod.optimize_reference(state, I1, grid, cfg_one)
    np.testing.assert_allclose(np.asarray(early.p_cur),
                               np.asarray(one.p_cur), atol=1e-6)


def test_min_iter_disabled_clauses_match_fixed_trip(rng):
    """min_iter=1 with dp_thresh=0 and dr_thresh=inf never fires the
    early exits: identical to the fixed-trip loop."""
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12,
                    min_iter=1, dp_thresh=0.0, dr_thresh=1e10)
    img0, img1 = _images(rng, 40, 56)
    state, I1, grid = _setup(img0, img1, cfg)
    a = _jit_optimize(state, I1, grid, cfg)
    cfg_fixed = DISConfig(patch_size=8, patch_stride=0.4,
                          grad_descent_iter=12)
    b = dis_mod.optimize_reference(state, I1, grid, cfg_fixed)
    np.testing.assert_allclose(np.asarray(a.p_cur), np.asarray(b.p_cur),
                               atol=1e-6)


def test_min_iter_dr_clause_freezes_nonimproving(rng):
    """dr_thresh=0 freezes every patch the moment its residual stops
    IMPROVING by definition (ratio > 0 always) once past min_iter=1 —
    again equal to one iteration."""
    cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12,
                    min_iter=1, dr_thresh=0.0)
    img0, img1 = _images(rng, 40, 56)
    state, I1, grid = _setup(img0, img1, cfg)
    early = _jit_optimize(state, I1, grid, cfg)
    one = dis_mod.optimize_reference(
        state, I1, grid, DISConfig(patch_size=8, patch_stride=0.4,
                                   grad_descent_iter=1))
    np.testing.assert_allclose(np.asarray(early.p_cur),
                               np.asarray(one.p_cur), atol=1e-6)
