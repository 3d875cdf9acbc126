"""Per-stage device time and kernel-launch count at operating point 2,
from a profiler trace of each stage run alone on the card.

    python tools/stage_profile.py [--sizes 4k,1024] [--out DIR]

Stages (inputs generated on the device from a seed):

    pool_l0_f32 / pool_l0_u8   the first 2x2 pool of a frame (float32 /
                               uint8 ingest), against its bytes moved
    gn_<backend>_s<scale>      one scale's Gauss-Newton solve
    varref_s<scale>            one scale's variational refinement
    step                       one whole streamed frame (pyramid + all
                               scales + upsample)

For each stage: wall time per call (host clock around block_until_ready),
device time per call (the sum of kernel durations on the GPU's stream
lines of the trace), kernels launched per call, and for the pools the
achieved bandwidth.  Requires a GPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SIZES = {"4k": (2176, 3840), "1024": (448, 1024)}


def device_events(trace_dir: str):
    """(name, duration_ns) of every kernel on the GPU planes' stream
    lines of the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                out += [(e.name, e.duration_ns) for e in line.events]
    return out


def profile(fn, args, n: int = 10) -> dict:
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / n * 1e3
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(n):
                out = fn(*args)
            jax.block_until_ready(out)
        ev = device_events(d)
    return {"wall_ms": wall, "device_ms": sum(e[1] for e in ev) / n / 1e6,
            "launches": len(ev) / n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="4k,1024")
    args = ap.parse_args(argv)

    import dataclasses
    import jax
    import jax.numpy as jnp
    from flowonthego.config import operating_point
    from flowonthego.models.dis_flow import (dis_flow_from_pyramids,
                                             upsample_flow_to_full)
    from flowonthego.ops import dis as dis_mod
    from flowonthego.ops import variational as var_mod
    from flowonthego.ops.patches import (PatchGrid,
                                         extract_templates_and_hessians)
    from flowonthego.ops.pyramid import _downsample_half_flat, build_pyramid
    from flowonthego.utils import device, synth
    from flowonthego.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = device.require_gpu()[0]
    card = device.card()
    print(f"device {dev.device_kind}; nvidia-smi: {card}", flush=True)

    def report(size, name, r, extra=""):
        print(f"{size} {name}: wall {r['wall_ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, {r['launches']:.0f} kernels/call"
              f"{extra}", flush=True)

    for size in args.sizes.split(","):
        H, W = SIZES[size]
        cfg = operating_point(2, width=W)
        a, b = synth.frame(0, H, W), synth.frame(1, H, W)

        # --- level-0 pool, float32 and uint8 ingest
        for tag, x in (("f32", a), ("u8", jnp.round(a).astype(jnp.uint8))):
            flat = x.reshape(H, W * 3)
            fn = jax.jit(lambda v: _downsample_half_flat(v, 3))
            r = profile(fn, (flat,))
            nbytes = flat.size * flat.dtype.itemsize + flat.size // 4 * 4
            report(size, f"pool_l0_{tag}", r,
                   f", {nbytes / 1e6:.1f} MB moved, "
                   f"{nbytes / r['device_ms'] / 1e6:.0f} GB/s")

        # --- per-scale GN solve and var-ref on the pyramid of the pair
        n_levels = cfg.coarsest_scale + 1
        pyr = jax.jit(lambda v: build_pyramid(v, n_levels, cfg.padding,
                                              start_level=cfg.finest_scale))
        p0, p1 = pyr(a), pyr(b)
        for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
            grid = PatchGrid.create(cfg, W >> sl, H >> sl)
            st = jax.jit(lambda i, gx, gy: dis_mod.init_state(
                *extract_templates_and_hessians(i, gx, gy, grid, cfg),
                grid))(p0[sl].image, p0[sl].grad_x, p0[sl].grad_y)
            for backend in ("pallas", "xla"):
                c = dataclasses.replace(cfg, gn_backend=backend)
                fn = jax.jit(lambda s, i, c=c: dis_mod.optimize(s, i, grid,
                                                                c))
                report(size, f"gn_{backend}_s{sl}",
                       profile(fn, (st, p1[sl].image)),
                       f", {grid.n_patches} patches")
            h, w, p = H >> sl, W >> sl, cfg.padding
            im1 = p0[sl].image[p:p + h, p:p + w]
            im2 = p1[sl].image[p:p + h, p:p + w]
            flow = jnp.zeros((h, w, 2), jnp.float32)
            fn = jax.jit(lambda f, i1, i2, sl=sl: var_mod.variational_refine(
                f, i1, i2, cfg, sl))
            report(size, f"varref_s{sl}", profile(fn, (flow, im1, im2)),
                   f", {w}x{h} field")

        # --- one whole streamed frame
        init = jnp.zeros((H >> (cfg.coarsest_scale + 1),
                          W >> (cfg.coarsest_scale + 1), 2), jnp.float32)

        @jax.jit
        def step(pyr_prev, frame, init):
            pyr_new = build_pyramid(frame, n_levels, cfg.padding,
                                    start_level=cfg.finest_scale)
            f = dis_flow_from_pyramids(pyr_prev, pyr_new, cfg,
                                       init_flow=init)
            return upsample_flow_to_full(f, cfg, H, W)
        r = profile(step, (p0, b, init))
        report(size, "step", r, f", device idle share "
               f"{1 - r['device_ms'] / r['wall_ms']:.3f} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
