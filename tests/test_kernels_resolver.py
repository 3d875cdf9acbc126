"""The one place that picks the Gauss-Newton solve's form
(ops/kernels.py): chosen from the configuration, never from the default
backend, and never the Pallas interpreter unless a caller asks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowonthego.config import DISConfig
from flowonthego.ops import dis as dis_mod
from flowonthego.ops import kernels
from flowonthego.ops.patches import PatchGrid, extract_templates_and_hessians
from flowonthego.ops.pyramid import central_diff, pad_constant, pad_replicate


@pytest.mark.parametrize("overrides,route", [
    ({}, "auto"),
    ({"gn_backend": "xla"}, "xla"),
    ({"gn_backend": "pallas"}, "pallas"),
    ({"res_thresh": 0.1}, "reference"),
    ({"cost_fn": "huber"}, "reference"),
    ({"min_iter": 3}, "reference"),
    ({"min_iter": 12}, "auto"),          # == grad_descent_iter: fixed trip
])
def test_gn_route(overrides, route):
    assert kernels.gn_route(DISConfig(**overrides)) == route


def test_unknown_gn_backend_is_rejected():
    with pytest.raises(ValueError, match="gn_backend"):
        DISConfig(gn_backend="mosaic")


def _solve_jaxpr(cfg):
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((24, 32, 3)).astype(np.float32) * 255)
    grid = PatchGrid.create(cfg, 32, 24)
    gx, gy = central_diff(img)
    st = dis_mod.init_state(*extract_templates_and_hessians(
        pad_replicate(img, cfg.padding), pad_constant(gx, cfg.padding),
        pad_constant(gy, cfg.padding), grid, cfg), grid)
    I1p = pad_replicate(img, cfg.padding)
    return str(jax.make_jaxpr(
        lambda s, i: dis_mod.optimize(s, i, grid, cfg))(st, I1p))


@pytest.mark.parametrize("backend,has_kernel,has_platform_switch", [
    ("auto", True, True),     # both forms traced, one lowered per platform
    ("xla", False, False),
    ("pallas", True, False),
])
def test_dispatch_traces_the_chosen_forms(backend, has_kernel,
                                          has_platform_switch):
    cfg = DISConfig(coarsest_scale=0, finest_scale=0, grad_descent_iter=2,
                    gn_backend=backend)
    jaxpr = _solve_jaxpr(cfg)
    assert ("pallas_call" in jaxpr) == has_kernel
    assert ("platform_index" in jaxpr) == has_platform_switch
    assert "interpret=True" not in jaxpr.replace(" ", "")


def test_auto_runs_the_xla_loop_on_cpu():
    """Lowered for the CPU, "auto" is the XLA loop bit for bit — not the
    interpreter, not an error."""
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.random((48, 64, 3)).astype(np.float32) * 255)
    b = jnp.roll(a, 1, axis=1)
    from flowonthego.models.dis_flow import compute_flow
    cfg = DISConfig(coarsest_scale=1, finest_scale=0)
    auto = np.asarray(compute_flow(a, b, cfg))
    xla = np.asarray(compute_flow(a, b, dataclasses.replace(
        cfg, gn_backend="xla")))
    np.testing.assert_array_equal(auto, xla)


def test_forced_kernel_does_not_fall_back_on_cpu():
    """gn_backend="pallas" lowered for the CPU fails loudly instead of
    quietly running the interpreter."""
    if jax.devices()[0].platform != "cpu":
        pytest.skip("checks the CPU lowering")
    cfg = DISConfig(coarsest_scale=0, finest_scale=0, grad_descent_iter=1,
                    gn_backend="pallas")
    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.random((24, 32, 3)).astype(np.float32))
    grid = PatchGrid.create(cfg, 32, 24)
    gx, gy = central_diff(img)
    st = dis_mod.init_state(*extract_templates_and_hessians(
        pad_replicate(img, cfg.padding), pad_constant(gx, cfg.padding),
        pad_constant(gy, cfg.padding), grid, cfg), grid)
    with pytest.raises(Exception, match="[Ii]nterpret"):
        jax.jit(lambda s, i: dis_mod.optimize(s, i, grid, cfg))(
            st, pad_replicate(img, cfg.padding))
