"""End-to-end time of the flow pipeline with the Gauss-Newton solve as
the Pallas kernel vs as the XLA loop, on one card, in one process.

    python tools/gn_compare.py [--rounds 3] [--cells op2_4k_stream,...]

Cells (frames generated on the device from a seed, so no upload is
timed):

    op2_4k_stream   stream_flow, op 2, 3840x2176, per frame
    op2_1024        compute_flow, op 2, 1024x436, per pair
    op3_1024        compute_flow, op 3, 1024x436, per pair
    op4_1024        compute_flow, op 4, 1024x436, per pair

Every variant is compiled first; then each round times the variants in
the order pallas, xla, xla, pallas, and the median over rounds is
printed with the card's name and power limit.  Requires a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CELLS = {
    "op2_4k_stream": (2, 2176, 3840, True),
    "op2_1024": (2, 436, 1024, False),
    "op3_1024": (3, 436, 1024, False),
    "op4_1024": (4, 436, 1024, False),
}


def _runner(op, h, w, streamed, backend, n):
    """A closure that runs n frames (or pairs) and waits for the last."""
    import jax
    from flowonthego.config import operating_point
    from flowonthego.models.dis_flow import compute_flow
    from flowonthego.parallel import stream_flow
    from flowonthego.utils import synth

    cfg = dataclasses.replace(operating_point(op, width=w),
                              gn_backend=backend)
    if streamed:
        frames = [synth.frame(t % 7, h, w) for t in range(n + 1)]

        def run():
            out = None
            for out in stream_flow(iter(frames), cfg, fetch=False):
                pass
            return jax.block_until_ready(out)
        return run, n
    a, b = synth.frame(0, h, w), synth.frame(1, h, w)

    def run():
        out = None
        for _ in range(n):
            out = compute_flow(a, b, cfg)
        return jax.block_until_ready(out)
    return run, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args(argv)

    import jax
    from flowonthego.utils import device
    from flowonthego.utils.cache import enable_compile_cache
    enable_compile_cache()
    dev = device.require_gpu()[0]
    card = device.card()
    print(f"device {dev.device_kind}; nvidia-smi: {card}", flush=True)
    for cell in args.cells.split(","):
        op, h, w, streamed = CELLS[cell]
        runs = {}
        for backend in ("pallas", "xla"):
            fn, n = _runner(op, h, w, streamed, backend, args.frames)
            t0 = time.perf_counter()
            fn()
            print(f"{cell} {backend}: warm-up {time.perf_counter() - t0:.1f}"
                  " s", flush=True)
            runs[backend] = (fn, n)
        times = {b: [] for b in runs}
        for _ in range(args.rounds):
            for backend in ("pallas", "xla", "xla", "pallas"):
                fn, n = runs[backend]
                t0 = time.perf_counter()
                fn()
                times[backend].append((time.perf_counter() - t0) / n * 1e3)
        med = {b: sorted(t)[len(t) // 2] for b, t in times.items()}
        unit = "ms/frame" if streamed else "ms/pair"
        print(f"{cell}: pallas {med['pallas']:.3f} {unit}, xla "
              f"{med['xla']:.3f} {unit} (all: "
              + "; ".join(f"{b} " + " ".join(f"{x:.3f}" for x in t)
                          for b, t in times.items())
              + f") [{dev.device_kind}, {card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
