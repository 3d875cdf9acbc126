"""Frame-batch (data-parallel) execution of the flow pipeline.

Streamed video is the reference's primary workload (docs/index.md:29-31 —
realtime frames/s is the headline metric).  The throughput path is a
batch of frame pairs vmapped through the whole pipeline and sharded over
the 'data' mesh axis; no communication is needed (SURVEY.md §2.4).

Also provides the video-streaming driver that carries frame t's flow as
frame t+1's warm start — the reference's ``initflow`` chaining
(src/oflow.cpp:268-271), which is how DIS is meant to run on video.
"""

from __future__ import annotations

import functools
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DISConfig
from ..models.dis_flow import dis_flow_padded, upsample_flow_to_full
from .mesh import DATA_AXIS


@functools.partial(jax.jit, static_argnames=("cfg", "full_res"))
def batched_flow(I0: jax.Array, I1: jax.Array, cfg: DISConfig,
                 full_res: bool = True) -> jax.Array:
    """Flow for a batch of padded frame pairs.

    I0, I1: [B, H, W, C] with H, W divisible by 2**coarsest_scale.
    Returns [B, H, W, 2] (full_res) or [B, H/2^fs, W/2^fs, 2].
    """
    flow = jax.vmap(lambda a, b: dis_flow_padded(a, b, cfg))(I0, I1)
    if full_res and cfg.finest_scale > 0:
        flow = jax.vmap(
            lambda f: upsample_flow_to_full(f, cfg, I0.shape[1], I0.shape[2])
        )(flow)
    return flow


def make_data_parallel_flow(mesh: Mesh, cfg: DISConfig, full_res: bool = True):
    """Jitted batch-flow with the batch axis sharded over 'data'.

    The pipeline is per-frame local, so XLA partitions it with zero
    collectives — linear scaling over chips for streamed video.
    """
    in_sh = NamedSharding(mesh, P(DATA_AXIS))
    out_sh = NamedSharding(mesh, P(DATA_AXIS))

    @functools.partial(jax.jit, in_shardings=(in_sh, in_sh),
                       out_shardings=out_sh)
    def fn(I0, I1):
        return batched_flow(I0, I1, cfg, full_res)

    return fn


@functools.lru_cache(maxsize=None)
def _stream_fns(cfg: DISConfig, full_res: bool):
    """The jitted (pyramid, step) pair of :func:`stream_flow`, built once
    per configuration so later streams reuse the compiled programs."""
    from ..models.dis_flow import dis_flow_from_pyramids
    from ..ops.pyramid import build_pyramid

    n_levels = cfg.coarsest_scale + 1

    @jax.jit
    def pyramid(I):
        return build_pyramid(I, n_levels, cfg.padding,
                             start_level=cfg.finest_scale)

    @jax.jit
    def step(pyr0, I1, init_flow):
        pyr1 = build_pyramid(I1, n_levels, cfg.padding,
                             start_level=cfg.finest_scale)
        flow = dis_flow_from_pyramids(pyr0, pyr1, cfg, init_flow=init_flow)
        out = (upsample_flow_to_full(flow, cfg, I1.shape[0], I1.shape[1])
               if full_res else flow)
        # warm start for the next pair: halve resolution of the finest
        # flow down to 1/2^(cs+1) (init is read at floor(mid/2) x2).
        init_h = I1.shape[0] >> (cfg.coarsest_scale + 1)
        init_w = I1.shape[1] >> (cfg.coarsest_scale + 1)
        nxt = jax.image.resize(flow / (2.0 ** (cfg.coarsest_scale + 1
                                               - cfg.finest_scale)),
                               (init_h, init_w, 2), method="linear")
        return out, pyr1, nxt

    return pyramid, step


def stream_flow(frames: Iterator[np.ndarray], cfg: DISConfig,
                full_res: bool = True, fetch: bool = True):
    """Sequential video streaming with flow warm-starting + pyramid reuse.

    Carries two things frame to frame:
      * the previous pair's flow (downsampled to the coarsest-scale
        warm-start resolution) as ``init_flow`` — the checkpoint/resume
        analogue of the reference (SURVEY.md §5, oflow.cpp:268-271);
      * the previous frame's PYRAMID: frame t is I1 of pair t-1 and I0
        of pair t, so each pyramid is built once and used twice.  The
        reference rebuilds both pyramids every pair (oflow.cpp:189-196)
        — at 4K that is the single largest per-frame cost paid twice.
    """
    pyramid, step = _stream_fns(cfg, full_res)
    pyr = None
    init = None
    shape0 = None
    for frame in frames:
        # uint8 frames stay uint8 on the way to the device (a quarter of
        # the bytes); the pyramid's first pool upcasts them
        cur = jnp.asarray(frame)
        if cur.dtype != jnp.uint8:
            cur = cur.astype(jnp.float32)
        if cur.ndim != 3 or cur.shape[2] not in (1, 3):
            raise ValueError(
                f"stream frame must be [H, W, 1|3], got {tuple(cur.shape)}")
        if shape0 is None:
            shape0 = cur.shape
            div = 2 ** cfg.coarsest_scale
            if shape0[0] % div or shape0[1] % div:
                raise ValueError(
                    f"stream frames must be pre-padded to 2^{cfg.coarsest_scale}"
                    f" divisibility, got {shape0[0]}x{shape0[1]}")
        elif cur.shape != shape0:
            raise ValueError(
                f"stream frame shape changed: {tuple(cur.shape)} vs "
                f"{tuple(shape0)} — all frames of a stream must match")
        if pyr is None:
            pyr = pyramid(cur)
            init_h = cur.shape[0] >> (cfg.coarsest_scale + 1)
            init_w = cur.shape[1] >> (cfg.coarsest_scale + 1)
            init = jnp.zeros((init_h, init_w, 2), jnp.float32)
            continue
        out, pyr, init = step(pyr, cur, init)
        # fetch=False keeps flows device-resident (the consumer decides
        # when to sync) — host transfer can dominate on slow links.
        yield np.asarray(out) if fetch else out
