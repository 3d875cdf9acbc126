"""Multi-chip streamed video: N warm-started streams over the 'data' axis.

The reference's headline workload is streamed video
(docs/index.md:29-31).  The single-device streaming loop
(:mod:`.frame_parallel`'s ``stream_flow``) carries two pieces of state
frame to frame — the previous frame's pyramid (built once, used twice)
and the previous pair's flow as the coarsest-scale warm start
(oflow.cpp:268-271).  This module runs N such loops at once, one per
chip: the stream batch axis is sharded over the 'data' mesh axis and
every carried tensor (all pyramid levels + the warm-start flow) lives
sharded on its chip, so each device advances its own stream with ZERO
collectives.

Deployment shapes this covers:
  * N live camera/video feeds, one per chip (the multi-feed server);
  * one long video split into N chunks processed in parallel (each chunk
    warm-starts cold; splice points lose only the warm start, not
    correctness — DIS re-converges within a frame).

Equivalence vs N sequential ``stream_flow`` runs is asserted on the
virtual 8-device mesh in tests/test_multistream.py and in
``__graft_entry__.dryrun_multichip`` (program 4).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DISConfig
from ..models.dis_flow import dis_flow_from_pyramids, upsample_flow_to_full
from ..ops.pyramid import build_pyramid
from .mesh import DATA_AXIS


class MultiStream:
    """N independent warm-started video streams sharded over 'data'.

    Frames are pushed as a batch [N, H, W, C] (or packed [N, H, W*C] —
    the layout-safe form for jit boundaries); one flow field per stream
    comes back, device-resident (``np.asarray`` when the host needs it).

    Usage::

        ms = MultiStream(mesh, cfg, H, W)
        ms.start(first_frames)          # builds sharded pyramids
        for batch in feed:              # [N, H, W, C] per tick
            flows = ms.push(batch)      # [N, H, W, 2] sharded over 'data'
    """

    def __init__(self, mesh: Mesh, cfg: DISConfig, height: int, width: int,
                 channels: int = 3, full_res: bool = True,
                 n_streams: Optional[int] = None):
        div = 2 ** cfg.coarsest_scale
        if height % div or width % div:
            raise ValueError(
                f"stream frames must be pre-padded to 2^{cfg.coarsest_scale}"
                f" divisibility, got {height}x{width}")
        self.mesh = mesh
        self.cfg = cfg
        self.H, self.W, self.C = height, width, channels
        self.full_res = full_res
        # default: one stream per 'data' shard; any multiple of the axis
        # size packs several streams onto each device
        n_data = int(mesh.shape[DATA_AXIS])
        self.n_streams = n_data if n_streams is None else int(n_streams)
        if self.n_streams % n_data:
            raise ValueError(f"n_streams={self.n_streams} is not a multiple "
                             f"of the mesh '{DATA_AXIS}' size {n_data}")
        self._sh = NamedSharding(mesh, P(DATA_AXIS))
        self._state = None

        cs, fs = cfg.coarsest_scale, cfg.finest_scale
        n_levels = cs + 1
        init_h, init_w = height >> (cs + 1), width >> (cs + 1)
        H, W, C = height, width, channels

        def one_pyramid(frame_flat):
            return build_pyramid(frame_flat.reshape(H, W, C), n_levels,
                                 cfg.padding, start_level=fs)

        def one_step(pyr_prev, frame_flat, init_flow):
            pyr_new = one_pyramid(frame_flat)
            flow = dis_flow_from_pyramids(pyr_prev, pyr_new, cfg,
                                          init_flow=init_flow)
            out = (upsample_flow_to_full(flow, cfg, H, W)
                   if full_res else flow)
            nxt = jax.image.resize(flow / (2.0 ** (cs + 1 - fs)),
                                   (init_h, init_w, 2), method="linear")
            return out, pyr_new, nxt

        @functools.partial(jax.jit, in_shardings=self._sh,
                           out_shardings=self._sh)
        def start_fn(frames_flat):
            pyr = jax.vmap(one_pyramid)(frames_flat)
            init = jnp.zeros((frames_flat.shape[0], init_h, init_w, 2),
                             jnp.float32)
            return pyr, init

        @functools.partial(jax.jit, in_shardings=(self._sh, self._sh),
                           out_shardings=self._sh, donate_argnums=(0,))
        def step_fn(state, frames_flat):
            pyr_prev, init = state
            out, pyr, nxt = jax.vmap(one_step)(pyr_prev, frames_flat, init)
            return out, (pyr, nxt)

        self._start_fn = start_fn
        self._step_fn = step_fn

    def _pack(self, frames) -> jax.Array:
        a = jnp.asarray(frames, jnp.float32)
        if a.ndim == 4:
            if a.shape[1:] != (self.H, self.W, self.C):
                raise ValueError(
                    f"stream batch must be [N, {self.H}, {self.W}, "
                    f"{self.C}], got {tuple(a.shape)}")
            a = a.reshape(a.shape[0], self.H, self.W * self.C)
        elif a.ndim != 3 or a.shape[1:] != (self.H, self.W * self.C):
            raise ValueError(
                f"stream batch must be [N, H, W, C] or packed [N, H, W*C],"
                f" got {tuple(a.shape)}")
        if a.shape[0] != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} streams, got batch of "
                f"{a.shape[0]}")
        return jax.device_put(a, self._sh)

    def start(self, first_frames) -> None:
        """Prime every stream with its first frame (no flow output)."""
        self._state = self._start_fn(self._pack(first_frames))

    def push(self, frames) -> jax.Array:
        """Advance every stream one frame; returns [N, H, W, 2] flows
        (sharded device array; each row is stream i's flow from its
        previous frame to this one)."""
        if self._state is None:
            raise RuntimeError("call start(first_frames) before push()")
        out, self._state = self._step_fn(self._state, self._pack(frames))
        return out


def stream_video_chunks(frames: np.ndarray, mesh: Mesh, cfg: DISConfig,
                        full_res: bool = True,
                        overlap_warmup: bool = True) -> np.ndarray:
    """Process ONE video of T frames as N parallel chunks over 'data'.

    Splits [T, H, W, C] into N contiguous chunks with one-frame overlap
    (chunk k's first frame is chunk k-1's last), runs them as N parallel
    streams, and reassembles the T-1 pairwise flows in order.  Chunk
    boundaries lose only the warm start (each chunk's first pair starts
    from zero init, like the reference's cold ``initflow``); every flow
    is still computed from its true frame pair.

    Returns [T-1, H, W, 2] (full_res) host array.
    """
    if frames.ndim != 4:
        raise ValueError(f"frames must be [T, H, W, C], got {frames.shape}")
    T = frames.shape[0]
    N = int(mesh.shape[DATA_AXIS])
    n_pairs = T - 1
    if n_pairs < N:
        raise ValueError(f"need at least {N + 1} frames for {N} chunks")
    H, W, C = frames.shape[1], frames.shape[2], frames.shape[3]
    ms = MultiStream(mesh, cfg, H, W, C, full_res=full_res)

    # chunk k handles pairs [starts[k], starts[k+1])
    starts = [k * n_pairs // N for k in range(N + 1)]
    ticks = max(starts[k + 1] - starts[k] for k in range(N))
    ms.start(np.stack([frames[starts[k]] for k in range(N)]))
    out = np.empty((n_pairs, H, W, 2) if full_res else
                   (n_pairs,
                    H >> cfg.finest_scale, W >> cfg.finest_scale, 2),
                   np.float32)
    for t in range(ticks):
        # streams past their chunk end re-feed their last frame (flow
        # result discarded) so every tick keeps the full batch shape
        idx = [min(starts[k] + 1 + t, starts[k + 1]) for k in range(N)]
        flows = ms.push(np.stack([frames[i] for i in idx]))
        flows = np.asarray(flows)
        for k in range(N):
            p = starts[k] + t
            if p < starts[k + 1]:
                out[p] = flows[k]
    return out
