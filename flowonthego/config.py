"""Configuration for the DIS optical-flow engine.

One frozen dataclass covers what the reference splits across ``opt_params``
(src/params.h:23-65) and the CLI operating points
(src/run_dense.cpp:166-227).  Derived quantities
(patch stride in pixels, thresholds, scale count) are computed once in
``__post_init__`` exactly as the reference derives them in its orchestrator
ctor (src/oflow.cpp:44-55).

Everything here is static Python — configs are hashable and act as
``static_argnums`` under ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

GN_BACKENDS = ("auto", "xla", "pallas")


def auto_coarsest_scale(width: int, patch_size: int, f_ratio: int = 5) -> int:
    """Auto-select the coarsest pyramid scale.

    Mirrors ``AutoFirstScaleSelect`` (src/run_dense.cpp:107-112):
    ``floor(log2(2*width / (f_ratio * patch_size)))``, clamped at 0.
    ``1/f_ratio * width`` is the maximum expected motion magnitude.
    """
    scale = (2.0 * float(width)) / (float(f_ratio) * float(patch_size))
    return max(0, int(math.floor(math.log2(scale))))


@dataclasses.dataclass(frozen=True)
class DISConfig:
    """Static parameters of the DIS pipeline (one instance per compile).

    Defaults correspond to operating point 2 of the reference
    (src/run_dense.cpp:201-207) with the scale range left
    to :func:`operating_point` / :meth:`with_auto_scales` to fill in.
    """

    # Explicit parameters (mirrors opt_params, src/params.h:25-42)
    patch_size: int = 8
    patch_stride: float = 0.4
    coarsest_scale: int = 5
    finest_scale: int = 3
    grad_descent_iter: int = 12
    use_mean_normalization: bool = True
    use_var_ref: bool = True
    var_ref_iter: int = 3          # SOR iterations per inner fixed-point iter
    var_ref_alpha: float = 10.0    # smoothness weight
    var_ref_gamma: float = 10.0    # gradient-constancy weight
    var_ref_delta: float = 5.0     # color-constancy weight
    var_ref_sor_weight: float = 1.6  # SOR over-relaxation omega

    # Termination thresholds (src/oflow.cpp:53-55). With res_thresh == 0 and
    # the GPU port's min_iter == max_iter, the gradient-descent loop runs a
    # fixed ``grad_descent_iter`` trips (see ops/dis.py) — dp/dr only matter
    # in the reference at the final iteration where they are moot.
    dp_thresh: float = 0.05 * 0.05
    dr_thresh: float = 0.95
    res_thresh: float = 0.0

    # Minimum GD iterations before the dp/dr convergence clauses can fire
    # (kroeger/oflow.h:37-38, patch.cpp:277-282).  None = grad_descent_iter
    # (the GPU port's fixed-trip semantics — all 4 published operating
    # points set min_iter == max_iter).  Setting min_iter < grad_descent_iter
    # enables the CPU baseline's 20-param early-exit behavior.
    min_iter: "Optional[int]" = None

    # Fixed parameters (src/params.h:49-50)
    min_errval: float = 2.0
    norm_outlier: float = 5.0    # pseudo-Huber width b

    # Patch photometric cost: "l2" (the GPU reference's only mode),
    # "l1" or "huber" (CPU baseline's costfct 1/2, kroeger/patch.cpp:223-262:
    # the residual image is transformed to sign(d)*sqrt(|d|) resp.
    # sign(d)*sqrt(2b^2(sqrt(1+d^2/b^2)-1)) before projection, and the
    # per-pixel densification weight becomes |d'| instead of d'^2).
    cost_fn: str = "l2"

    # Densification pixel weight: "squared" = GPU reference semantics
    # (1/sum_c max(minerr, d_c^2), densify.cu:75-78); "abs" = CPU baseline
    # semantics (1/sum_c max(minerr, |d_c|), kroeger/patchgrid.cpp:254-258).
    # The two references themselves diverge here.
    densify_weight: str = "squared"

    # dtype for the compute path ("float32" matches the reference; "bfloat16"
    # is an experimental fast path for the interpolation gathers).
    dtype: str = "float32"

    # Gauss-Newton solve: "auto" (the persistent Pallas kernel where the
    # program is compiled for a CUDA device, the XLA loop elsewhere),
    # "xla" or "pallas" (ops/kernels.py).  The kernel is the analogue of
    # the reference's single persistent-loop launch
    # (src/kernels/optimize.cu:97-243).
    gn_backend: str = "auto"

    # Forward-backward consistency: optimize a complementary I1->I0 grid
    # and merge its reversed flow during densification (the CPU
    # reference's ``usefbcon``, kroeger/oflow.cpp:162-170; off in all of
    # the reference's published benchmarks).
    use_fb_consistency: bool = False

    def __post_init__(self):
        if self.patch_size % 2 != 0:
            raise ValueError("patch_size must be even")
        if not (0.0 < self.patch_stride < 1.0):
            raise ValueError("patch_stride must be in (0, 1)")
        if self.finest_scale > self.coarsest_scale:
            raise ValueError("finest_scale must be <= coarsest_scale")
        if self.finest_scale < 0:
            raise ValueError("finest_scale must be >= 0")
        if self.gn_backend not in GN_BACKENDS:
            raise ValueError(f"gn_backend must be one of {GN_BACKENDS}, "
                             f"got {self.gn_backend!r}")

    # ---- Derived parameters (src/oflow.cpp:44-55) ----

    @property
    def steps(self) -> int:
        """Distance in px between patch centers."""
        return max(1, int(math.floor(self.patch_size * (1.0 - self.patch_stride))))

    @property
    def n_vals(self) -> int:
        """Values per RGB patch (3 * ps^2)."""
        return 3 * self.patch_size * self.patch_size

    @property
    def n_scales(self) -> int:
        return self.coarsest_scale - self.finest_scale + 1

    @property
    def outlier_thresh(self) -> float:
        """Displacement (px) beyond which a patch resets to its init flow."""
        return float(self.patch_size) / 2.0

    @property
    def padding(self) -> int:
        """Image padding on all sides: replicate for images, zero for
        gradients (src/run_dense.cpp:263)."""
        return self.patch_size

    def with_auto_scales(self, width: int, f_ratio: int = 5,
                         depth: Optional[int] = None) -> "DISConfig":
        """Return a config whose scale range is auto-selected for ``width``.

        ``depth`` is the number of scales below the coarsest (the reference
        uses coarsest-2 for op points 1/2, coarsest-4/5 for 3/4).
        """
        if depth is None:
            depth = self.coarsest_scale - self.finest_scale
        coarsest = auto_coarsest_scale(width, self.patch_size, f_ratio)
        finest = max(coarsest - depth, 0)
        return dataclasses.replace(self, coarsest_scale=coarsest,
                                   finest_scale=finest)


def operating_point(op_point: int, width: Optional[int] = None,
                    f_ratio: int = 5) -> DISConfig:
    """The reference's four CLI operating points
    (src/run_dense.cpp:181-209).

    If ``width`` is given, the scale range is auto-selected for that image
    width, matching ``AutoFirstScaleSelect``.
    """
    if op_point == 1:
        cfg = DISConfig(patch_size=8, patch_stride=0.3, grad_descent_iter=16,
                        use_var_ref=False)
        depth = 2
    elif op_point == 2:
        cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12,
                        use_var_ref=True)
        depth = 2
    elif op_point == 3:
        cfg = DISConfig(patch_size=12, patch_stride=0.75, grad_descent_iter=16,
                        use_var_ref=True)
        depth = 4
    elif op_point == 4:
        cfg = DISConfig(patch_size=12, patch_stride=0.75, grad_descent_iter=128,
                        use_var_ref=True)
        depth = 5
    else:
        raise ValueError(f"unknown operating point {op_point} (expected 1-4)")

    if width is not None:
        cfg = cfg.with_auto_scales(width, f_ratio=f_ratio, depth=depth)
    else:
        cfg = dataclasses.replace(
            cfg, coarsest_scale=5, finest_scale=max(5 - depth, 0))
    return cfg


def pad_to_divisible(width: int, height: int, coarsest_scale: int):
    """Padding needed so width/height divide evenly down the pyramid.

    Mirrors src/run_dense.cpp:231-253: pad to a multiple of
    ``2**coarsest_scale``; split as floor/ceil between the two sides.
    Returns ``(pad_top, pad_bottom, pad_left, pad_right)``.
    """
    max_scale = 2 ** coarsest_scale
    padw = (-width) % max_scale
    padh = (-height) % max_scale
    return (padh // 2, padh - padh // 2, padw // 2, padw - padw // 2)
