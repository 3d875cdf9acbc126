"""2-D tile-sharded pipeline == unsharded pipeline on the fake CPU mesh.

Covers SURVEY.md §2.4's "spatial/model axis over image tiles" for the
FULL DIS core (extraction, warm start, optimization, densification fold,
tiled var-ref).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from flowonthego.config import DISConfig
from flowonthego.models.dis_flow import flow_full_padded
from flowonthego.parallel.spatial_tile2d import (make_tile2d_flow,
                                                 make_tile_mesh,
                                                 tiled2d_scale_levels)


def _smooth_pair(rng, H, W, dy=3, dx=2):
    base = gaussian_filter(
        rng.standard_normal((H + 16, W + 16, 3)).astype(np.float32),
        (3, 3, 0)) * 120 + 128
    A = jnp.asarray(base[:H, :W])
    B = jnp.asarray(base[dy:dy + H, dx:dx + W])
    return A, B


def _check(mesh_shape, cfg, H, W, rng):
    mesh = make_tile_mesh(*mesh_shape, devices=jax.devices()[:8])
    n_r, n_c = mesh_shape
    assert cfg.finest_scale in tiled2d_scale_levels(cfg, H, W, n_r, n_c), \
        "test must exercise a genuinely tiled finest scale"
    A, B = _smooth_pair(rng, H, W)
    fn = make_tile2d_flow(mesh, cfg, H, W, with_diagnostics=True)
    sharded, viol = fn(A, B)
    sharded = np.asarray(jax.block_until_ready(sharded))
    assert int(viol) == 0, f"halo budget exceeded for {int(viol)} patches"
    ref = np.asarray(flow_full_padded(A, B, cfg))
    d = np.abs(sharded - ref)
    q50 = float(np.quantile(d, 0.5))
    q95 = float(np.quantile(d, 0.95))
    # same caps as the strip path's dryrun: ulp-level fp-order differences
    # can flip a marginal DIS outlier reset, which var-ref then diffuses;
    # a broken halo/fold shows px-scale errors at tile boundaries
    assert q50 < 5e-4 and q95 < 5e-3 and float(d.max()) < 0.05, \
        f"{mesh_shape}: q50={q50:.2e} q95={q95:.2e} max={float(d.max()):.3f}"


@pytest.mark.parametrize("mesh_shape", [
    (2, 4),
    pytest.param((4, 2), marks=pytest.mark.slow),   # transposed mesh: same
    # code paths as (2, 4) with swapped axis roles; kept as a slow-suite
    # regression
])
def test_tile2d_matches_unsharded(mesh_shape, rng):
    cfg = DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=8,
                    use_var_ref=True)
    n_r, n_c = mesh_shape
    _check(mesh_shape, cfg, H=80 * n_r, W=80 * n_c, rng=rng)


def test_tile2d_without_varref(rng):
    cfg = DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=8,
                    use_var_ref=False)
    _check((2, 4), cfg, H=48 * 2, W=48 * 4, rng=rng)


def test_tile2d_fb_consistency(rng):
    """usefbcon (kroeger/oflow.cpp:162-170) fully tiled: the backward
    grid's reversed-flow merge is a 2-D tile scatter folded into all
    four neighbors (_fb_merge_tile)."""
    cfg = DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=8,
                    use_var_ref=True, use_fb_consistency=True)
    _check((2, 4), cfg, H=80 * 2, W=80 * 4, rng=rng)


@pytest.mark.slow
def test_tile2d_fb_changes_result(rng):
    """fb merge must actually contribute (guards against a silently
    dropped backward accumulator)."""
    H, W = 80 * 4, 80 * 8
    cfg = DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=8,
                    use_var_ref=False)
    cfg_fb = dataclasses.replace(cfg, use_fb_consistency=True)
    mesh = make_tile_mesh(2, 4, devices=jax.devices()[:8])
    A, B = _smooth_pair(rng, H, W)
    plain = np.asarray(make_tile2d_flow(mesh, cfg, H, W,
                                        with_diagnostics=False)(A, B))
    fb = np.asarray(make_tile2d_flow(mesh, cfg_fb, H, W,
                                     with_diagnostics=False)(A, B))
    assert np.abs(fb - plain).max() > 1e-6
