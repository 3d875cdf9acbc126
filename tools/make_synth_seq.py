"""Write a generated video sequence with known ground-truth flow.

Frames come from flowonthego.utils.synth: an analytic texture moved by a
smooth non-rigid displacement (|flow| <= --max-disp px per frame), so
every consecutive pair has exact dense ground truth.  Writes binary PPM
frames (no PIL needed) and, with --flo, the ground-truth .flo of each
pair.

Usage:
    python tools/make_synth_seq.py seq4k --frames 17 --width 3840 --height 2160
    python tools/flow_stream.py seq4k --op 2
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--max-disp", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flo", action="store_true",
                    help="also write flow_TTTT.flo (pair t -> t+1)")
    args = ap.parse_args()

    from flowonthego.io.flo import write_flo
    from flowonthego.io.images import save_image
    from flowonthego.utils import synth

    os.makedirs(args.out_dir, exist_ok=True)
    h, w = args.height, args.width
    for t in range(args.frames):
        frame = np.asarray(synth.frame(t, h, w, args.seed,
                                       max_disp=args.max_disp))
        save_image(os.path.join(args.out_dir, f"frame_{t:04d}.ppm"), frame)
        if args.flo and t + 1 < args.frames:
            write_flo(os.path.join(args.out_dir, f"flow_{t:04d}.flo"),
                      np.asarray(synth.flow(t, h, w, args.seed,
                                            max_disp=args.max_disp)))
        print(f"frame_{t:04d}.ppm  ({w}x{h})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
