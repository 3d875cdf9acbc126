"""Halo-coupled row-sharded DIS vs the unsharded pipeline.

The equivalence bar is tight (atol 1e-3): extraction halos, strip
sampling offsets, and the densification boundary fold must reproduce the
single-device math, not just approximate it (SURVEY.md hard parts 1-2).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flowonthego.config import DISConfig
from flowonthego.models.dis_flow import (dis_flow_padded,
                                         flow_full_padded,
                                         upsample_flow_to_full)
from flowonthego.parallel import make_mesh
from flowonthego.parallel.spatial_fine import (make_fine_spatial_flow,
                                               sharded_scale_levels,
                                               displacement_bound)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 (virtual) devices")


def _smooth(rng, h, w):
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(
        rng.standard_normal((h, w, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128


def test_displacement_bound_and_level_selection():
    cfg = DISConfig(patch_size=8, coarsest_scale=4, finest_scale=1)
    assert displacement_bound(cfg, 4) == 4.0
    assert displacement_bound(cfg, 1) == 32.0
    # H=512, 4 shards: strips are 128 rows; scale1 strip=64 needs halo 40
    levels = sharded_scale_levels(cfg, 512, 4)
    assert 1 in levels


@pytest.mark.parametrize("use_var_ref", [
    pytest.param(False, marks=pytest.mark.slow),  # the capability-matrix
    # tests exercise the sharded no-varref paths at the same geometry
    True,
])
def test_fine_sharded_matches_single(rng, use_var_ref):
    cfg = DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                    finest_scale=1, grad_descent_iter=8,
                    use_var_ref=use_var_ref)
    mesh = make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    # var-ref adds halo slack, which needs taller strips to stay sharded
    H, W = (512, 64) if use_var_ref else (256, 64)
    assert 1 in sharded_scale_levels(cfg, H, 4)
    I0 = _smooth(rng, H, W)
    I1 = np.roll(np.roll(I0, 2, axis=1), 1, axis=0)

    fn = make_fine_spatial_flow(mesh, cfg, H, W)
    sharded, viol = fn(jnp.asarray(I0), jnp.asarray(I1))
    sharded = np.asarray(sharded)
    assert int(viol) == 0

    full = np.asarray(flow_full_padded(jnp.asarray(I0), jnp.asarray(I1),
                                       cfg))

    np.testing.assert_allclose(sharded, full, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mode", ["fb", "l1_res", "huber"])
def test_fine_sharded_capability_matrix(rng, mode):
    """fb-consistency / robust costs / res_thresh>0 run sharded and match
    the unsharded pipeline (the reference composes all of these freely,
    kroeger/oflow.cpp:162-296)."""
    kw = dict(patch_size=8, patch_stride=0.4, coarsest_scale=2,
              finest_scale=1, grad_descent_iter=8, use_var_ref=False)
    if mode == "fb":
        kw["use_fb_consistency"] = True
    elif mode == "l1_res":
        # one compile covers both reference-form branches: robust L1 cost
        # AND the res_thresh early-exit clause (they compose freely,
        # kroeger/oflow.cpp:162-296)
        kw["cost_fn"] = "l1"
        kw["res_thresh"] = 10.0
    else:
        kw["cost_fn"] = mode
    cfg = DISConfig(**kw)
    mesh = make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    H, W = 256, 64
    assert 1 in sharded_scale_levels(cfg, H, 4)
    I0 = _smooth(rng, H, W)
    I1 = np.roll(np.roll(I0, 2, axis=1), 1, axis=0)

    fn = make_fine_spatial_flow(mesh, cfg, H, W)
    sharded, viol = fn(jnp.asarray(I0), jnp.asarray(I1))
    sharded = np.asarray(sharded)
    assert int(viol) == 0

    full = np.asarray(flow_full_padded(jnp.asarray(I0), jnp.asarray(I1),
                                       cfg))
    np.testing.assert_allclose(sharded, full, rtol=1e-3, atol=1e-3)


def test_fine_sharded_fb_with_varref(rng):
    """fb + variational refinement together on the sharded path."""
    cfg = DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                    finest_scale=1, grad_descent_iter=8, use_var_ref=True,
                    use_fb_consistency=True)
    mesh = make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    H, W = 512, 64
    assert 1 in sharded_scale_levels(cfg, H, 4)
    I0 = _smooth(rng, H, W)
    I1 = np.roll(np.roll(I0, 2, axis=1), 1, axis=0)

    fn = make_fine_spatial_flow(mesh, cfg, H, W)
    sharded, viol = fn(jnp.asarray(I0), jnp.asarray(I1))
    sharded = np.asarray(sharded)
    assert int(viol) == 0

    full = np.asarray(flow_full_padded(jnp.asarray(I0), jnp.asarray(I1),
                                       cfg))
    np.testing.assert_allclose(sharded, full, rtol=1e-3, atol=1e-3)


def test_halo_large_motion_within_budget(rng):
    """Motion near the halo budget: sharded == unsharded and the runtime
    halo detector reports zero violations."""
    cfg = DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                    finest_scale=1, grad_descent_iter=8, use_var_ref=True)
    mesh = make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    H, W = 512, 64
    I0 = _smooth(rng, H, W)
    I1 = np.roll(I0, 9, axis=0)   # large vertical motion (rows cross strips)

    fn = make_fine_spatial_flow(mesh, cfg, H, W, with_diagnostics=True)
    sharded, viol = fn(jnp.asarray(I0), jnp.asarray(I1))
    assert int(viol) == 0

    full = np.asarray(flow_full_padded(jnp.asarray(I0), jnp.asarray(I1),
                                       cfg))
    np.testing.assert_allclose(np.asarray(sharded), full,
                               rtol=1e-3, atol=1e-3)


def test_halo_exceeded_is_detected(rng, monkeypatch):
    """Starve the halo (displacement bound forced to ~0): sampling clamps,
    and the runtime detector reports it instead of silently diverging."""
    import flowonthego.parallel.spatial_fine as sf
    monkeypatch.setattr(sf, "displacement_bound", lambda cfg, sl: 0.0)
    cfg = DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                    finest_scale=1, grad_descent_iter=8, use_var_ref=False)
    mesh = make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    H, W = 256, 64
    I0 = _smooth(rng, H, W)
    I1 = np.roll(I0, 6, axis=0)

    fn = sf.make_fine_spatial_flow(mesh, cfg, H, W, with_diagnostics=True)
    _, viol = fn(jnp.asarray(I0), jnp.asarray(I1))
    assert int(viol) > 0


def test_fine_sharded_finest_zero(rng):
    """finest_scale=0: the full-resolution scale itself runs sharded."""
    cfg = DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                    finest_scale=0, grad_descent_iter=8, use_var_ref=False)
    mesh = make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    H, W = 256, 64
    assert 0 in sharded_scale_levels(cfg, H, 4)
    I0 = _smooth(rng, H, W)
    I1 = np.roll(I0, 2, axis=1)

    fn = make_fine_spatial_flow(mesh, cfg, H, W)
    sharded, viol = fn(jnp.asarray(I0), jnp.asarray(I1))
    sharded = np.asarray(sharded)
    assert int(viol) == 0
    # fs=0: flow_full_padded's upsample is the identity
    single = np.asarray(flow_full_padded(jnp.asarray(I0), jnp.asarray(I1),
                                         cfg))
    np.testing.assert_allclose(sharded, single, rtol=1e-3, atol=1e-3)


def test_halo_exceeded_recovers_to_unsharded(rng):
    """Recovery, not just detection: a starved
    halo (slack forced negative) trips the certificate, and the
    recovering wrapper re-runs the frame on the replicated path — the
    caller gets the unsharded result, never silently clamped flow."""
    from flowonthego.parallel.spatial_fine import \
        make_fine_spatial_flow_recovering
    cfg = DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                    finest_scale=1, grad_descent_iter=8, use_var_ref=False)
    mesh = make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    H, W = 256, 64
    I0 = _smooth(rng, H, W)
    I1 = np.roll(I0, 6, axis=0)

    fn = make_fine_spatial_flow_recovering(mesh, cfg, H, W, halo_slack=-6)
    flow, viol = fn(jnp.asarray(I0), jnp.asarray(I1))
    assert int(viol) > 0, "test must actually starve the halo"

    # the fallback IS the replicated jitted program — bit-exact vs the
    # same program; the eager pipeline differs by fusion-order ulps
    replicated = jax.jit(lambda a, b: upsample_flow_to_full(
        dis_flow_padded(a, b, cfg), cfg, H, W))
    full = np.asarray(replicated(jnp.asarray(I0), jnp.asarray(I1)))
    np.testing.assert_array_equal(np.asarray(flow), full)

    # and with a healthy budget the wrapper passes the sharded result
    fn_ok = make_fine_spatial_flow_recovering(mesh, cfg, H, W)
    flow_ok, viol_ok = fn_ok(jnp.asarray(I0), jnp.asarray(I1))
    assert int(viol_ok) == 0
    np.testing.assert_allclose(np.asarray(flow_ok), full,
                               rtol=1e-3, atol=1e-3)
