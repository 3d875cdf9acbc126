"""2D-tiled variational refinement == unsharded, on the fake 8-CPU mesh.

Covers SURVEY.md §2.4's "spatial axis over H x W tiles" row: per-sweep
SOR halos exchange both rows AND columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowonthego.config import DISConfig
from flowonthego.ops.variational import variational_refine
from flowonthego.parallel.halo import (exchange_accumulate_cols,
                                       exchange_cols)
from flowonthego.parallel.varref_tiled2d import (make_tile_mesh,
                                                 make_tiled_varref)


def _problem(H=64, W=96, C=3, seed=0):
    rng = np.random.default_rng(seed)
    im1 = jnp.asarray(rng.uniform(0, 255, (H, W, C)), jnp.float32)
    # im2 = im1 shifted + noise so the data term has real structure
    im2 = jnp.roll(im1, (2, -3), axis=(0, 1)) + jnp.asarray(
        rng.normal(0, 2.0, (H, W, C)), jnp.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = 3.0 * np.sin(yy / 17.0) + 1.5 * np.cos(xx / 23.0)
    v = -2.0 * np.cos(yy / 13.0) + 1.0 * np.sin(xx / 29.0)
    flow = jnp.asarray(np.stack([u, v], -1), jnp.float32)
    return flow, im1, im2


# ------------------------------------------------------------- column halos

def test_exchange_cols_matches_pad():
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map
    from functools import partial

    devs = jax.devices()[:4]
    mesh = Mesh(np.asarray(devs).reshape(1, 4), ("r", "c"))
    x = jnp.arange(8 * 32 * 2, dtype=jnp.float32).reshape(8, 32, 2)

    for mode, pad_mode in (("edge", "edge"), ("zero", "constant")):
        @partial(shard_map, mesh=mesh, in_specs=P(None, "c", None),
                 out_specs=P(None, "c", None))
        def ex(xl):
            return exchange_cols(xl, 3, "c", mode=mode)[:, 3:-3]

        # interior halo correctness: extended-then-cropped is identity
        np.testing.assert_array_equal(np.asarray(ex(x)), np.asarray(x))

        @partial(shard_map, mesh=mesh, in_specs=P(None, "c", None),
                 out_specs=P(None, "c", None))
        def ex_keep(xl):
            h = exchange_cols(xl, 3, "c", mode=mode)
            return h[:, 2:-4]  # shift window left by 1: col i reads i-1

        shifted = np.asarray(ex_keep(x))
        ref = np.pad(np.asarray(x), ((0, 0), (3, 3), (0, 0)),
                     mode=pad_mode)[:, 2:-4]
        np.testing.assert_array_equal(shifted, ref)


def test_exchange_accumulate_cols_total_preserved():
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map
    from functools import partial

    devs = jax.devices()[:4]
    mesh = Mesh(np.asarray(devs).reshape(1, 4), ("r", "c"))
    rng = np.random.default_rng(1)
    halo = 2
    # each shard's accumulator: [4, 8 + 2*halo]
    acc = jnp.asarray(rng.normal(size=(4, 4 * (8 + 2 * halo))), jnp.float32)

    @partial(shard_map, mesh=mesh, in_specs=P(None, "c"),
             out_specs=P(None, "c"))
    def fold(a):
        return exchange_accumulate_cols(a, halo, "c")

    out = np.asarray(fold(acc))
    # reference: overlap-add of the 4 local accumulators on the global axis
    ref = np.zeros((4, 4 * 8))
    a = np.asarray(acc).reshape(4, 4, 8 + 2 * halo)
    for i in range(4):
        lo = i * 8 - halo
        for k in range(8 + 2 * halo):
            g = lo + k
            if 0 <= g < 4 * 8:
                ref[:, g] += a[:, i, k]
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- tiled refinement

@pytest.mark.parametrize("n_r,n_c", [(2, 4), (4, 2), (8, 1)])
def test_tiled_varref_matches_unsharded(n_r, n_c):
    flow, im1, im2 = _problem()
    cfg = DISConfig()
    level = 2

    expected = np.asarray(variational_refine(flow, im1, im2, cfg, level))

    mesh = make_tile_mesh(n_r, n_c)
    halo = int(np.ceil(np.abs(np.asarray(flow)).max())) + 2
    run = jax.jit(make_tiled_varref(mesh, cfg, level,
                                    flow.shape[0], flow.shape[1], halo))
    got = np.asarray(run(flow, im1, im2))

    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-5)


def test_tiled_varref_level0_and_small_halo_clamp():
    # level 0 (single inner iteration) and a halo that exactly covers the
    # displacement bound
    flow, im1, im2 = _problem(H=32, W=64, seed=3)
    cfg = DISConfig()
    expected = np.asarray(variational_refine(flow, im1, im2, cfg, 0))
    mesh = make_tile_mesh(2, 4)
    halo = int(np.ceil(np.abs(np.asarray(flow)).max())) + 2
    run = jax.jit(make_tiled_varref(mesh, cfg, 0, 32, 64, halo))
    got = np.asarray(run(flow, im1, im2))
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-5)


def test_tile_mesh_divisibility_error():
    mesh = make_tile_mesh(2, 4)
    cfg = DISConfig()
    with pytest.raises(ValueError, match="not divisible"):
        make_tiled_varref(mesh, cfg, 1, 63, 96, 4)
