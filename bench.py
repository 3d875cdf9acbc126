"""Benchmark harness: frames/sec on the reference's headline workloads.

Prints the device it ran on, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Runs in one process on one GPU and refuses to run without one.  Frames
are generated from a seed (flowonthego.utils.synth: an analytic texture
under a known smooth flow), so EPE is measured against exact ground
truth.

Methodology: per-frame device time is measured by chaining N dependent
pipeline executions inside one jitted fori_loop and fetching a single
scalar, which amortizes dispatch the way a streaming deployment does.
Two variants:
  * ms_* (headline) — STREAMED video: each chained iteration ingests one
    new frame, builds its pyramid once, and reuses the carried previous
    frame's pyramid + warm-start flow (the deployment loop; the
    reference's 25 fps 4K claim is likewise a video number).
  * ms_*_pair — cold two-frame call (both pyramids built, no warm start).
fps_* = 1000 / ms.

Baseline: the reference CUDA implementation runs 1024x448 and 4K at
~40 ms/frame (25 fps) on a Jetson TX2 (docs/index.md:29-31, 173-175;
BASELINE.md).  Headline metric: 4K fps, op point 2.
"""

import json
import sys
import time


def chain_timer(step, args, n=48, trials=5):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(*a):
        def body(i, acc):
            out = step(*(x + acc * 1e-12 for x in a))
            return acc + jnp.sum(out) * 1e-20
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    float(chained(*args))  # compile + warm
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        float(chained(*args))
        times.append((time.perf_counter() - t0) / n)
    times.sort()
    return times[len(times) // 2] * 1e3


def stream_chain_timer(H, W, cfg, frame_flat, n=192, trials=3):
    """Per-frame device time of STREAMED video flow.

    Chains n frames through the streaming step: each iteration ingests a
    'new' frame (the base frame perturbed by the carried scalar — one
    full-frame read, like a real ingest), builds ITS pyramid once, and
    computes flow against the carried previous pyramid with the carried
    warm-start flow.  This is the deployment loop (frame t's pyramid is
    reused as pair t+1's I0 pyramid; the reference instead rebuilds both
    pyramids every pair, oflow.cpp:189-196).
    """
    import jax
    import jax.numpy as jnp
    from flowonthego.models.dis_flow import (dis_flow_from_pyramids,
                                             upsample_flow_to_full)
    from flowonthego.ops.pyramid import build_pyramid

    n_levels = cfg.coarsest_scale + 1
    init_h, init_w = H >> (cfg.coarsest_scale + 1), W >> (cfg.coarsest_scale + 1)

    def pyramid(If, bias=None):
        # bias emulates ingesting a new frame; it is fused into the first
        # pyramid level's read (a standalone full-frame add costs a
        # 100 MB read+write at 4K) — a real deployment's frames arrive as
        # fresh device buffers and pay neither.
        return build_pyramid(If.reshape(H, W, 3), n_levels, cfg.padding,
                             start_level=cfg.finest_scale,
                             ingest_bias=bias)

    @jax.jit
    def chained(If):
        pyr0 = pyramid(If)
        init0 = jnp.zeros((init_h, init_w, 2), jnp.float32)

        def body(i, carry):
            pyr_prev, init, acc = carry
            pyr_new = pyramid(If, bias=acc * 1e-12)  # ingest one new frame
            flow = dis_flow_from_pyramids(pyr_prev, pyr_new, cfg,
                                          init_flow=init)
            out = upsample_flow_to_full(flow, cfg, H, W)
            nxt = jax.image.resize(
                flow / (2.0 ** (cfg.coarsest_scale + 1 - cfg.finest_scale)),
                (init_h, init_w, 2), method="linear")
            return pyr_new, nxt, acc + jnp.sum(out) * 1e-20
        _, _, acc = jax.lax.fori_loop(0, n, body, (pyr0, init0,
                                                   jnp.float32(0.0)))
        return acc

    float(chained(frame_flat))  # compile + warm
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        float(chained(frame_flat))
        times.append((time.perf_counter() - t0) / n)
    times.sort()
    return times[len(times) // 2] * 1e3


def multi_stream_chain_timer(H, W, cfg, frame_flat, n_streams=4, n=32,
                             trials=3):
    """Per-TICK device time of n_streams warm-started streams advancing
    together on one chip (the per-chip unit of parallel/multistream.py's
    multi-chip program).  Returns ms per tick (= n_streams frames)."""
    import jax
    import jax.numpy as jnp
    from flowonthego.models.dis_flow import (dis_flow_from_pyramids,
                                             upsample_flow_to_full)
    from flowonthego.ops.pyramid import build_pyramid

    n_levels = cfg.coarsest_scale + 1
    init_h, init_w = H >> (cfg.coarsest_scale + 1), W >> (cfg.coarsest_scale + 1)

    def pyramid(If):
        return build_pyramid(If.reshape(H, W, 3), n_levels, cfg.padding,
                             start_level=cfg.finest_scale)

    def one_step(pyr_prev, If, init):
        pyr_new = pyramid(If)
        flow = dis_flow_from_pyramids(pyr_prev, pyr_new, cfg, init_flow=init)
        out = upsample_flow_to_full(flow, cfg, H, W)
        nxt = jax.image.resize(
            flow / (2.0 ** (cfg.coarsest_scale + 1 - cfg.finest_scale)),
            (init_h, init_w, 2), method="linear")
        return out, pyr_new, nxt

    @jax.jit
    def chained(If):
        frames = jnp.stack([If + 0.25 * i for i in range(n_streams)])
        pyr0 = jax.vmap(pyramid)(frames)
        init0 = jnp.zeros((n_streams, init_h, init_w, 2), jnp.float32)

        def body(i, carry):
            pyr_prev, init, acc = carry
            out, pyr, nxt = jax.vmap(one_step)(
                pyr_prev, frames + acc * 1e-12, init)
            return pyr, nxt, acc + jnp.sum(out) * 1e-20
        _, _, acc = jax.lax.fori_loop(0, n, body,
                                      (pyr0, init0, jnp.float32(0.0)))
        return acc

    float(chained(frame_flat))
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        float(chained(frame_flat))
        times.append((time.perf_counter() - t0) / n)
    times.sort()
    return times[len(times) // 2] * 1e3


def _make_step(H, W, cfg):
    """Step over FLAT [H, W*3] frames.

    Frames are stored packed (2D), as a streaming deployment keeps
    them; the in-jit reshape to [H, W, 3] is a free bitcast.
    """
    from flowonthego.models.dis_flow import (dis_flow_padded,
                                             upsample_flow_to_full)

    def step(I0f, I1f):
        I0 = I0f.reshape(H, W, 3)
        I1 = I1f.reshape(H, W, 3)
        flow = dis_flow_padded(I0, I1, cfg)
        return upsample_flow_to_full(flow, cfg, H, W)
    return step


def _padded_pair(cfg, h, w, seed=0):
    """A generated pair at (h, w), edge-padded to the config's
    divisibility, with its ground-truth flow."""
    import numpy as np
    from flowonthego.config import pad_to_divisible
    from flowonthego.utils import synth
    A, B, gt = synth.pair(h, w, seed)
    pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)
    Ap = np.pad(A, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    Bp = np.pad(B, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    return Ap, Bp, (pt, pb, pl, pr), gt


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flowonthego.config import operating_point
    from flowonthego.utils import device
    from flowonthego.utils.cache import enable_compile_cache
    from flowonthego.utils.logfilter import install_stderr_noise_filter
    from flowonthego.utils.metrics import average_epe
    install_stderr_noise_filter()
    enable_compile_cache()
    devs = device.require_gpu()
    print(f"# device: platform {devs[0].platform}, kind "
          f"{devs[0].device_kind}, count {len(devs)}; nvidia-smi: "
          f"{device.card()}", file=sys.stderr, flush=True)

    make_step = _make_step
    results = {}

    # ---- 4K (3840x2160 padded to 3840x2176), op 2 ----
    H4, W4 = 2176, 3840
    cfg4 = operating_point(2, width=W4)
    A4, B4, _, _ = _padded_pair(cfg4, H4, W4)
    I0 = jax.device_put(A4.reshape(H4, -1))
    I1 = jax.device_put(B4.reshape(H4, -1))
    results["ms_4k_pair"] = chain_timer(make_step(H4, W4, cfg4), (I0, I1))
    # headline: streamed 4K video (the reference's 25 fps claim is also a
    # video-processing number) — one pyramid build per frame, warm start
    results["ms_4k"] = stream_chain_timer(H4, W4, cfg4, I0)
    results["fps_4k"] = 1000.0 / results["ms_4k"]
    # uint8 ingest (deployment video frames): the first pool upcasts
    # inside its read, so the full-res frame read moves 1/4 the bytes
    I0u8 = jax.device_put(np.round(A4).astype(np.uint8).reshape(H4, -1))
    results["ms_4k_u8"] = stream_chain_timer(H4, W4, cfg4, I0u8)
    del I0, I1, I0u8

    # ---- 1024x436 (Sintel geometry, padded 1024x448), op 2 + EPE ----
    h, w = 436, 1024
    cfg1 = operating_point(2, width=w)
    Ap, Bp, (pt, pb, pl, pr), gt = _padded_pair(cfg1, h, w)
    H1, W1 = Ap.shape[:2]
    step1 = make_step(H1, W1, cfg1)
    I0s = jnp.asarray(Ap.reshape(H1, -1))
    I1s = jnp.asarray(Bp.reshape(H1, -1))
    results["ms_1024x436_pair"] = chain_timer(step1, (I0s, I1s))
    results["ms_1024x436"] = stream_chain_timer(H1, W1, cfg1, I0s)
    results["fps_1024x436"] = 1000.0 / results["ms_1024x436"]
    flow = np.asarray(jax.jit(step1)(I0s, I1s))[pt:pt + h, pl:pl + w]
    results["epe_vs_gt_1024x436"] = average_epe(flow, gt)

    # ---- operating points 1, 3, 4 at 1024x436 ----
    for op in (1, 3, 4):
        cfg_op = operating_point(op, width=w)
        A, B, _, _ = _padded_pair(cfg_op, h, w)
        Hn, Wn = A.shape[:2]
        results[f"ms_1024x436_op{op}"] = chain_timer(
            _make_step(Hn, Wn, cfg_op),
            (jnp.asarray(A.reshape(Hn, -1)), jnp.asarray(B.reshape(Hn, -1))),
            n=32, trials=3)

    # ---- 1080p streamed ----
    cfg_hd = operating_point(2, width=1920)
    R, _, _, _ = _padded_pair(cfg_hd, 1080, 1920)
    Hr, Wr = R.shape[:2]
    results["ms_1080p"] = stream_chain_timer(Hr, Wr, cfg_hd,
                                             jnp.asarray(R.reshape(Hr, -1)))
    results["fps_1080p"] = 1000.0 / results["ms_1080p"]

    # ---- 4 streams of 1024x436 advancing together ----
    results["ms_1024x436_4streams"] = multi_stream_chain_timer(
        H1, W1, cfg1, I0s, n_streams=4, n=96, trials=3)
    results["fps_1024x436_agg4"] = 4000.0 / results["ms_1024x436_4streams"]

    out = {
        "metric": "fps_4k_op2",
        "value": round(results["fps_4k"], 3),
        "unit": "frames/sec",
        "vs_baseline": round(results["fps_4k"] / 25.0, 3),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }
    out.update({k: round(v, 5 if k.startswith("epe") else 3)
                for k, v in results.items()})
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
