"""Distributed-path tests on a fake 8-CPU-device mesh (SURVEY.md §4).

Verifies: halo exchange primitives, data-parallel batch == per-frame
results, and the spatially-sharded pipeline == the unsharded pipeline
(bit-level determinism is a design invariant — no atomics anywhere).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from flowonthego.config import DISConfig
from flowonthego.models.dis_flow import dis_flow_padded, upsample_flow_to_full
from flowonthego.parallel import (make_mesh, make_data_parallel_flow,
                                  make_spatial_flow)
from flowonthego.parallel.halo import exchange_rows, exchange_accumulate_rows

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")


def _smooth(rng, h, w):
    from scipy.ndimage import gaussian_filter
    img = rng.standard_normal((h, w, 3)).astype(np.float32)
    return gaussian_filter(img, sigma=(3, 3, 0)) * 120 + 128


def test_exchange_rows_edge_and_interior(rng):
    mesh = make_mesh(n_data=1, n_space=8)
    x = rng.standard_normal((32, 4)).astype(np.float32)

    def worker(xs):
        return exchange_rows(xs, halo=2, axis_name="space", mode="edge")

    out = jax.jit(shard_map(worker, mesh=mesh, in_specs=P("space"),
                            out_specs=P("space")))(jnp.asarray(x))
    out = np.asarray(out)  # [8 * (4+4), 4]
    shards = out.reshape(8, 8, 4)
    for i in range(8):
        lo, hi = i * 4, (i + 1) * 4
        np.testing.assert_array_equal(shards[i, 2:6], x[lo:hi])
        if i > 0:
            np.testing.assert_array_equal(shards[i, :2], x[lo - 2:lo])
        else:
            np.testing.assert_array_equal(shards[i, :2],
                                          np.repeat(x[:1], 2, 0))
        if i < 7:
            np.testing.assert_array_equal(shards[i, 6:], x[hi:hi + 2])
        else:
            np.testing.assert_array_equal(shards[i, 6:],
                                          np.repeat(x[-1:], 2, 0))


def test_exchange_accumulate_matches_dense_overlap_add(rng):
    """Sharded scatter-with-margins == dense accumulation."""
    mesh = make_mesh(n_data=1, n_space=8)
    halo, h_local = 2, 4
    # every shard produces a local accumulator with margins
    locals_ = rng.standard_normal((8, h_local + 2 * halo, 3)).astype(np.float32)

    def worker(acc):
        return exchange_accumulate_rows(acc[0], halo, "space")[None]

    out = jax.jit(shard_map(worker, mesh=mesh, in_specs=P("space"),
                            out_specs=P("space")))(jnp.asarray(locals_))
    out = np.asarray(out).reshape(8 * h_local, 3)

    dense = np.zeros((8 * h_local, 3), np.float64)
    for i in range(8):
        start = i * h_local - halo
        for r in range(h_local + 2 * halo):
            g = start + r
            if 0 <= g < 8 * h_local:
                dense[g] += locals_[i, r]
    np.testing.assert_allclose(out, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_data_parallel_matches_single(rng):
    cfg = DISConfig(coarsest_scale=3, finest_scale=1, use_var_ref=True,
                    grad_descent_iter=8)
    mesh = make_mesh(n_data=8, n_space=1)
    h, w, b = 32, 32, 8
    I0 = np.stack([_smooth(np.random.default_rng(i), h, w) for i in range(b)])
    I1 = np.stack([_smooth(np.random.default_rng(i + 100), h, w)
                   for i in range(b)])
    fn = make_data_parallel_flow(mesh, cfg)
    batched = np.asarray(fn(jnp.asarray(I0), jnp.asarray(I1)))

    for i in [0, 3, 7]:
        single = dis_flow_padded(jnp.asarray(I0[i]), jnp.asarray(I1[i]), cfg)
        single = upsample_flow_to_full(single, cfg, h, w)
        np.testing.assert_allclose(batched[i], np.asarray(single),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_spatial_matches_single(rng):
    cfg = DISConfig(coarsest_scale=4, finest_scale=2, use_var_ref=True,
                    grad_descent_iter=8)
    mesh = make_mesh(n_data=1, n_space=8)
    h, w = 128, 64   # 16 rows/shard, divisible by 2^fs = 4... and 2^cs=16
    I0 = _smooth(rng, h, w)
    I1 = np.roll(I0, shift=2, axis=1)
    fn = make_spatial_flow(mesh, cfg, h, w)
    sharded = np.asarray(fn(jnp.asarray(I0), jnp.asarray(I1)))

    single = dis_flow_padded(jnp.asarray(I0), jnp.asarray(I1), cfg)
    full = np.asarray(upsample_flow_to_full(single, cfg, h, w))
    np.testing.assert_allclose(sharded, full, rtol=1e-4, atol=1e-4)
