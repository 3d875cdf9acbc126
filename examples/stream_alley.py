"""Streamed-video demo: dense flow over a directory of frames.

Mirrors the reference's headline use case (realtime flow on streamed
video, docs/index.md:15-31): frame decode -> device-resident pipeline ->
flow warm-started from the previous pair (oflow.cpp:268-271 initflow
chaining).  Frames come from
tools/make_synth_seq.py, which also writes the ground truth:

    python tools/make_synth_seq.py seq --frames 50 --width 1024 --height 436 --flo
    python examples/stream_alley.py seq [--save-dir OUT] [--frames N]
"""

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir", help="directory of frame_*.ppm|png")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--op-point", type=int, default=2)
    ap.add_argument("--no-fetch", action="store_true",
                    help="keep flows on device (the device streaming rate, "
                         "without the per-frame host fetch)")
    args = ap.parse_args()

    from flowonthego.config import operating_point, pad_to_divisible
    from flowonthego.io.flo import read_flo
    from flowonthego.io.flo import write_flo
    from flowonthego.io.images import load_image
    from flowonthego.parallel import stream_flow
    from flowonthego.utils.cache import enable_compile_cache
    from flowonthego.utils.metrics import average_epe
    enable_compile_cache()

    paths = sorted(glob.glob(os.path.join(args.frames_dir, "frame_*.ppm"))
                   or glob.glob(os.path.join(args.frames_dir, "frame_*.png")))
    paths = paths[:args.frames]
    print(f"streaming {len(paths)} frames")

    # pad every frame identically so the jit traces once
    h, w = load_image(paths[0]).shape[:2]
    cfg = operating_point(args.op_point, width=w)
    pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)

    def padded_frames():
        for p in paths:
            frame = load_image(p)
            yield np.pad(frame, ((pt, pb), (pl, pr), (0, 0)), mode="edge")

    n = 0
    t0 = None
    last = None
    epes = []
    for flow in stream_flow(padded_frames(), cfg, fetch=not args.no_fetch):
        if t0 is None:
            t0 = time.perf_counter()   # skip compile in rate measurement
        last = flow
        if not args.no_fetch:
            out = flow[pt:pt + h, pl:pl + w]
            gt = os.path.join(args.frames_dir, f"flow_{n:04d}.flo")
            if os.path.exists(gt):
                epes.append(average_epe(out, read_flo(gt)))
            if args.save_dir:
                write_flo(os.path.join(args.save_dir,
                                       f"flow_{n + 1:04d}.flo"), out)
        n += 1
    if args.no_fetch:
        _ = float(np.asarray(last).sum())   # sync once at the end
    dt = time.perf_counter() - t0
    mode = ("device-resident" if args.no_fetch
            else "includes full-flow host fetch per frame")
    print(f"{n} flows; steady-state {dt / max(n - 1, 1) * 1e3:.2f} ms/frame "
          f"({(n - 1) / dt:.1f} fps) [{mode}]")
    if epes:
        print(f"mean EPE vs ground truth: {np.mean(epes):.4f} px")


if __name__ == "__main__":
    main()
