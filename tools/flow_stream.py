"""Streaming/webcam loop — analogue of the reference's live demo
(ref/flow_ref.cpp:365-461), which grabs webcam frames in
a loop, computes DIS flow, colorizes it, and reports per-frame timing.

Sources (positional argument):
  * a directory of frames (sorted; e.g. one written by
    tools/make_synth_seq.py)
  * a video file or a webcam index (anything cv2.VideoCapture accepts)

Each consecutive pair goes through the warm-started streaming pipeline
(`parallel/frame_parallel.stream_flow` — the previous flow seeds the
coarsest scale, matching how DIS is deployed on video).  Per-frame wall
time and fps are printed like the reference's loop; ``--out DIR`` writes
color-wheel PNGs, ``--flo DIR`` writes the raw .flo fields.

Usage:
  python tools/make_synth_seq.py seq --frames 9 --width 1024 --height 436
  python tools/flow_stream.py seq --op 2
  python tools/flow_stream.py video.mp4 --out viz --max-frames 100
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def frame_source(src: str, max_frames: int, prefetch_threads: int = 3):
    """Yield BGR float32 [H, W, 3] frames from a directory, file, or cam.

    Directories go through the native threaded prefetcher (io/native.py
    FrameStream — decode runs in C++ worker threads ahead of the consumer,
    the ingest half of the reference's zero-copy host pipeline); falls
    back to synchronous decode when the library isn't built.
    """
    if os.path.isdir(src):
        names = sorted(os.listdir(src))
        names = [os.path.join(src, n) for n in names
                 if n.lower().endswith((".png", ".jpg", ".jpeg", ".ppm"))]
        names = names[:max_frames]
        stream = None
        try:
            from flowonthego.io.native import FrameStream
            stream = FrameStream(names, n_threads=prefetch_threads)
        except RuntimeError:
            pass
        if stream is not None:
            yield from stream
        else:
            from flowonthego.io.images import load_image
            for n in names:
                yield load_image(n)
        return
    import cv2
    cap = cv2.VideoCapture(int(src) if src.isdigit() else src)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video source {src!r}")
    count = 0
    while count < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        yield frame.astype(np.float32)
        count += 1
    cap.release()


def main() -> int:
    ap = argparse.ArgumentParser(
        description="streaming optical flow (webcam-loop analogue)")
    ap.add_argument("source", help="frame directory, video file, or cam index")
    ap.add_argument("--op", type=int, default=2, help="operating point 1-4")
    ap.add_argument("--out", help="write color-wheel PNGs to this directory")
    ap.add_argument("--flo", help="write .flo fields to this directory")
    ap.add_argument("--max-frames", type=int, default=10 ** 9)
    ap.add_argument("--no-fetch", action="store_true",
                    help="keep flows device-resident (no per-frame host "
                         "transfer; one sync at the end) — measures the "
                         "ingest+dispatch-limited server loop, without the "
                         "per-frame device->host link cost")
    args = ap.parse_args()
    if args.no_fetch and (args.out or args.flo):
        raise SystemExit("--no-fetch cannot write per-frame outputs")

    from flowonthego.utils.cache import enable_compile_cache
    enable_compile_cache()

    from flowonthego.config import operating_point, pad_to_divisible
    from flowonthego.io.color import flow_to_color
    from flowonthego.io.flo import write_flo
    from flowonthego.io.images import save_image
    from flowonthego.parallel.frame_parallel import stream_flow
    from flowonthego.utils.timing import warmup

    frames = frame_source(args.source, args.max_frames)
    first = next(frames, None)
    if first is None:
        raise SystemExit("no frames")
    h, w = first.shape[:2]
    cfg = operating_point(args.op, width=w)
    pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)

    def padded():
        yield np.pad(first, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
        for f in frames:
            yield np.pad(f, ((pt, pb), (pl, pr), (0, 0)), mode="edge")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.flo:
        os.makedirs(args.flo, exist_ok=True)

    warmup()
    print(f"streaming {w}x{h} at operating point {args.op} "
          f"(cs={cfg.coarsest_scale}, fs={cfg.finest_scale})")
    t_prev = time.perf_counter()
    n = 0
    total_ms = 0.0
    last = None
    for i, flow_p in enumerate(stream_flow(padded(), cfg,
                                           fetch=not args.no_fetch)):
        if args.no_fetch:
            last = flow_p                 # device-resident; no sync here
            now = time.perf_counter()
            ms = (now - t_prev) * 1e3
            t_prev = now
            n += 1
            if n > 1:
                total_ms += ms
            print(f"frame {i + 1:4d}: {ms:8.2f} ms (dispatch)", flush=True)
            continue
        flow = flow_p[pt:pt + h, pl:pl + w]
        now = time.perf_counter()
        ms = (now - t_prev) * 1e3
        t_prev = now
        n += 1
        if n > 1:           # first pair pays the compile
            total_ms += ms
        mag = np.sqrt((flow ** 2).sum(-1))
        print(f"frame {i + 1:4d}: {ms:8.2f} ms  |flow| mean "
              f"{mag.mean():6.3f} max {mag.max():6.2f}", flush=True)
        if args.out:
            save_image(os.path.join(args.out, f"flow_{i + 1:04d}.png"),
                       flow_to_color(flow)[..., ::-1])
        if args.flo:
            write_flo(os.path.join(args.flo, f"flow_{i + 1:04d}.flo"), flow)
    if args.no_fetch and last is not None:
        import jax
        t0 = time.perf_counter()
        jax.block_until_ready(last)
        np.asarray(last)
        print(f"final sync + fetch: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    if n > 1:
        avg = total_ms / (n - 1)
        what = "dispatch-limited" if args.no_fetch else "incl. host I/O"
        print(f"{n} flows, steady-state {avg:.2f} ms/frame "
              f"({1000.0 / avg:.1f} fps {what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
