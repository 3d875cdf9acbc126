"""Command-line driver: ``python -m flowonthego img1 img2 out.flo [...]``.

Mirrors the reference CLI contract (src/run_dense.cpp:115-318):

    flow img1 img2 out.flo                 # operating point 2
    flow img1 img2 out.flo <op_point>      # 1..4
    flow img1 img2 out.flo <coarsest> <finest> <gd_iter> <patch_size>
         <patch_stride> <use_mean_norm> <use_var_ref> <alpha> <gamma>
         <delta> <var_iter> <sor_omega> <verbosity>

Output: Middlebury .flo at the input resolution.  ``--viz out.png``
additionally writes the color-wheel visualization (tools/color_flow
equivalent).

``--mode depth`` switches to 1-D stereo disparity (the reference CPU
baseline's run_DE_* SELECTMODE=2 variant) and writes a PFM file
(img1 = left, img2 = right; pass ``--cam 1`` for the mirrored pair).

``--min-iter N`` enables the CPU baseline's 20-param-form early-exit
semantics: past N iterations the dp/dr convergence clauses may terminate
a patch before <gd_iter> trips (kroeger/patch.cpp:279-282).

Remaining CPU-baseline 20-param-form toggles (kroeger/README.md:71-88):
``--fb`` enables forward-backward consistency (usefbcon — the backward
grid's reversed flow merged during densification, kroeger/oflow.cpp:
162-170); ``--cost l2|l1|huber`` selects the patch cost function
(costfct, kroeger/patch.cpp:223-262); ``--densify-weight squared|abs``
selects the aggregation weighting (squared = GPU port, abs = CPU
baseline, kroeger/patchgrid.cpp:254-258).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .config import DISConfig, operating_point
from .io.color import flow_to_color
from .io.flo import write_flo
from .io.images import load_image, save_image
from .models.dis_flow import compute_flow
from .utils.cache import enable_compile_cache
from .utils.timing import warmup


def _pop_flag(argv, name, has_value=True, default=None):
    if name not in argv:
        return argv, default
    i = argv.index(name)
    if has_value:
        if i + 1 >= len(argv):
            print(f"error: {name} requires a value\n")
            print(__doc__)
            sys.exit(2)
        value = argv[i + 1]
        return argv[:i] + argv[i + 2:], value
    return argv[:i] + argv[i + 1:], True


def _parse_args(argv):
    argv, viz = _pop_flag(argv, "--viz")
    argv, mode = _pop_flag(argv, "--mode", default="flow")
    argv, cam = _pop_flag(argv, "--cam", default="0")
    argv, channels = _pop_flag(argv, "--channels", default="rgb")
    # CPU-baseline 20-param-form extras (kroeger/README.md:71-88): minimum
    # GD iterations before the dp/dr early-exit clauses may fire
    argv, min_iter = _pop_flag(argv, "--min-iter")
    argv, use_fb = _pop_flag(argv, "--fb", has_value=False, default=False)
    argv, cost_fn = _pop_flag(argv, "--cost")
    argv, densify_w = _pop_flag(argv, "--densify-weight")
    if cost_fn is not None and cost_fn not in ("l2", "l1", "huber"):
        print(f"error: --cost must be l2|l1|huber, got {cost_fn}\n")
        sys.exit(2)
    if densify_w is not None and densify_w not in ("squared", "abs"):
        print(f"error: --densify-weight must be squared|abs, "
              f"got {densify_w}\n")
        sys.exit(2)

    if len(argv) < 3:
        print(__doc__)
        sys.exit(2)
    img1, img2, out = argv[0], argv[1], argv[2]
    rest = argv[3:]
    return (img1, img2, out, rest, viz, mode, int(cam), channels,
            None if min_iter is None else int(min_iter),
            bool(use_fb), cost_fn, densify_w)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    (img1_path, img2_path, out_path, rest, viz, mode, cam,
     channels, min_iter, use_fb, cost_fn, densify_w) = _parse_args(argv)

    # Persistent compile cache: repeat CLI invocations skip XLA compiles.
    enable_compile_cache()

    t0 = time.perf_counter()
    I0 = load_image(img1_path)
    I1 = load_image(img2_path)
    width = I0.shape[1]
    if channels != "rgb":
        import numpy as _np
        from .ops.channels import prepare_input
        I0 = _np.asarray(prepare_input(I0, channels))
        I1 = _np.asarray(prepare_input(I1, channels))

    verbosity = 1
    if len(rest) <= 1:
        op_point = int(rest[0]) if rest else 2
        cfg = operating_point(op_point, width=width)
    else:
        vals = rest
        cfg = DISConfig(
            coarsest_scale=int(vals[0]),
            finest_scale=int(vals[1]),
            grad_descent_iter=int(vals[2]),
            patch_size=int(vals[3]),
            patch_stride=float(vals[4]),
            use_mean_normalization=bool(int(vals[5])),
            use_var_ref=bool(int(vals[6])),
            var_ref_alpha=float(vals[7]),
            var_ref_gamma=float(vals[8]),
            var_ref_delta=float(vals[9]),
            var_ref_iter=int(vals[10]),
            var_ref_sor_weight=float(vals[11]),
        )
        if len(vals) > 12:
            verbosity = int(vals[12])
    overrides = {}
    if min_iter is not None:
        overrides["min_iter"] = min_iter
    if use_fb:
        overrides["use_fb_consistency"] = True
    if cost_fn is not None:
        overrides["cost_fn"] = cost_fn
    if densify_w is not None:
        overrides["densify_weight"] = densify_w
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)

    if verbosity > 1:
        print(f"TIME (Image loading) (ms): "
              f"{(time.perf_counter() - t0) * 1e3:.3g}")
        print(f"config: {cfg}")

    warmup()
    t1 = time.perf_counter()
    if mode == "depth":
        import dataclasses
        from .io.pfm import write_pfm
        from .models.stereo import compute_disparity
        cfg_d = dataclasses.replace(cfg, use_var_ref=False)
        disp = np.asarray(compute_disparity(I0, I1, cfg=cfg_d, cam_lr=cam))
        if verbosity > 0:
            print(f"TIME (Depth Run-Time incl. compile) (ms): "
                  f"{(time.perf_counter() - t1) * 1e3:.3g}")
        write_pfm(out_path, disp)
        print(f"disparity {disp.shape[1]}x{disp.shape[0]} -> {out_path}")
        return 0
    if verbosity > 1:
        # reference verbosity-2 parity: per-scale phase timing lines
        # (src/oflow.cpp:346) + per-phase aggregates (printTimings)
        from .models.dis_flow import compute_flow_timed
        flow = np.asarray(compute_flow_timed(I0, I1, cfg=cfg))
    else:
        flow = np.asarray(compute_flow(I0, I1, cfg=cfg))
    if verbosity > 0:
        print(f"TIME (O.Flow Run-Time incl. compile) (ms): "
              f"{(time.perf_counter() - t1) * 1e3:.3g}")

    write_flo(out_path, flow)
    if viz:
        save_image(viz, flow_to_color(flow)[..., ::-1])  # color fn gives RGB
    if verbosity > 0:
        mag = np.sqrt((flow ** 2).sum(-1))
        print(f"flow {flow.shape[1]}x{flow.shape[0]}  "
              f"|flow| mean {mag.mean():.3f} max {mag.max():.3f}  -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
