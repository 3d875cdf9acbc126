"""Video streaming driver: warm-start chaining + pyramid reuse.

``stream_flow`` builds each frame's pyramid ONCE and reuses it as the next
pair's I0 pyramid (frame t is I1 of pair t-1 and I0 of pair t); the
reference rebuilds both pyramids per pair (oflow.cpp:189-196).  These
tests pin that the reuse is a pure restructuring: the streamed flows must
equal running each pair independently through ``dis_flow_padded`` with
the same ``initflow`` warm-start chaining (oflow.cpp:268-271).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowonthego.config import DISConfig
from flowonthego.models.dis_flow import (dis_flow_padded,
                                         upsample_flow_to_full)

# one traced program per (init None / init array) x full_res instead of
# hundreds of eager op dispatches per pair (see flow_full_padded)
import functools as _ft


@_ft.partial(jax.jit, static_argnames=("cfg", "full_res"))
def _pair_step(I0, I1, cfg, init, full_res):
    flow = dis_flow_padded(I0, I1, cfg, init_flow=init)
    out = (upsample_flow_to_full(flow, cfg, I0.shape[0], I0.shape[1])
           if full_res else flow)
    init_h = I0.shape[0] >> (cfg.coarsest_scale + 1)
    init_w = I0.shape[1] >> (cfg.coarsest_scale + 1)
    nxt = jax.image.resize(
        flow / (2.0 ** (cfg.coarsest_scale + 1 - cfg.finest_scale)),
        (init_h, init_w, 2), method="linear")
    return out, nxt
from flowonthego.parallel.frame_parallel import stream_flow

CFG = DISConfig(coarsest_scale=3, finest_scale=1, grad_descent_iter=4,
                use_var_ref=True)


def _frames(n, H, W, seed=0):
    """Smooth drifting scene: frame k is frame 0 rolled k pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.zeros((H, W, 3), np.float32)
    for _ in range(5):
        fx, fy = rng.uniform(1.0, 5.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
        base += 30.0 * np.sin(2 * np.pi * (fx * xx / W + fy * yy / H)[..., None]
                              + ph).astype(np.float32)
    base += 128.0
    return [np.roll(np.roll(base, 2 * k, axis=0), k, axis=1)
            for k in range(n)]


def _manual_chain(frames, cfg, full_res):
    """Reference semantics: independent pairs, warm-start carried."""
    outs = []
    init = None
    for I0, I1 in zip(frames[:-1], frames[1:]):
        I0 = jnp.asarray(I0, jnp.float32)
        I1 = jnp.asarray(I1, jnp.float32)
        out, init = _pair_step(I0, I1, cfg, init, full_res)
        outs.append(np.asarray(out))
    return outs


@pytest.mark.parametrize("full_res", [True, False])
def test_stream_flow_matches_pairwise_chain(full_res):
    frames = _frames(4, 64, 96)
    streamed = list(stream_flow(iter(frames), CFG, full_res=full_res))
    manual = _manual_chain(frames, CFG, full_res)
    assert len(streamed) == len(manual) == 3
    for k, (s, m) in enumerate(zip(streamed, manual)):
        assert s.shape == m.shape
        np.testing.assert_allclose(s, m, rtol=1e-5, atol=1e-4,
                                   err_msg=f"pair {k}")


def test_stream_flow_fetch_false_stays_on_device():
    frames = _frames(3, 64, 64)
    outs = list(stream_flow(iter(frames), CFG, fetch=False))
    assert len(outs) == 2
    assert all(isinstance(o, jax.Array) for o in outs)


def test_stream_flow_accuracy_on_known_motion():
    """Streamed flows recover the true constant motion of a drifting
    scene on every pair (the warm-start equivalence above proves the
    chaining; this pins end-to-end accuracy of the streamed numbers)."""
    H, W = 64, 96
    # np.roll(+2, axis=0)/(+1, axis=1) moves content down-right: a pixel
    # at (y, x) in frame k sits at (y+2, x+1) in frame k+1 -> flow (1, 2).
    frames = _frames(4, H, W, seed=3)
    cfg = DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=6,
                    use_var_ref=True)
    m = (slice(8, H - 8), slice(8, W - 8))
    for k, out in enumerate(stream_flow(iter(frames), cfg, full_res=True)):
        epe = np.hypot(out[m][..., 0] - 1.0,
                       out[m][..., 1] - 2.0).mean()
        assert epe < 0.35, f"pair {k}: EPE {epe:.3f}"


def test_stream_uint8_frames_match_their_float_cast(rng):
    """uint8 frames stay uint8 up to the device (the first pool upcasts
    them); 0..255 integers are exact in float32, so the flows equal those
    of the same frames cast to float32."""
    seq = (rng.random((3, 32, 64, 3)) * 255).astype(np.uint8)
    got = list(stream_flow(iter(seq), CFG))
    want = list(stream_flow(iter(seq.astype(np.float32)), CFG))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
