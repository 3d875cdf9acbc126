"""Per-scale Gauss-Newton patch solve as one persistent GPU kernel.

The reference runs each patch's inverse-search loop inside one CUDA
kernel (src/kernels/optimize.cu:97-243): one block per patch samples the
target image bilinearly from global memory, reduces within the block and
checks the outlier reset in place, for all iterations, in one launch.
This kernel takes the same shape through Pallas's Triton route: one
program owns a power-of-two block of patches and runs

  * every Gauss-Newton iteration (sample -> projection -> outlier/bounds
    reset, optimize.cu:23-94 and :66-88) in an in-kernel ``fori_loop``;
  * the final resample and signed residual (optimize.cu:193-208), from
    which the caller forms the per-pixel densification weights.

Each iteration reads the four bilinear taps of every patch pixel straight
from the padded level image with index-array loads (the level, at most a
few MB, stays in L2), so no window stack, envelope or band table is
built.  The arithmetic follows :func:`flowonthego.ops.dis.optimize`'s
XLA loop term by term (same blend order, same step and reset formulas);
only the order of the per-patch sums differs.

Layout: ``consts`` [32, Pp] (one row per per-patch scalar, patches on the
minor axis), the static weight stack ``w`` [3, Pp, NP] (template, gx, gy;
pixels padded to the power of two NP with zeros) and the per-pixel tap
offsets ``offs`` [NP] into the flattened image.  Outputs are the final
flow ``p`` [2, Pp] and the signed residual ``diff`` [Pp, NP].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Rows of the per-patch constant table (padded to a power of two).
(MID_X, MID_Y, OFF_X, OFF_Y, P_X, P_Y, P0_X, P0_Y, GX_SUM, GY_SUM, GX_T,
 GY_T, H00, H01, H11, DET, STARTED) = range(17)
N_CONST = 32

# Elements (patches x padded pixels) per program, e.g. 16 patches of 256
# padded pixels (ps 8, RGB) or 8 of 512 (ps 12, RGB), on four warps.  Not
# tuned: the first setting that beat the XLA loop on the card (PERF.md).
BLOCK_ELEMS = 4096
NUM_WARPS = 4


def padded_pixels(n: int) -> int:
    """Next power of two >= n (Triton block dims are powers of two)."""
    return 1 << max(0, (n - 1).bit_length())


def block_patches(n_pixels_padded: int) -> int:
    """Patches per program for a padded patch size NP."""
    return max(1, BLOCK_ELEMS // n_pixels_padded)


def _kernel(img_ref, offs_ref, c_ref, w_ref, p_ref, d_ref, *, n_iters: int,
            ps: int, C: int, Hp: int, Wp: int, padding: int, thresh: float,
            l_bound: float, ub_w: float, ub_h: float, mean_on: float,
            n_vals: float, bf16_samples: bool):
    f32 = jnp.float32
    WpC = Wp * C
    K = ps + 1
    off0 = padding - ps // 2
    offs = offs_ref[...]                               # [NP] int32
    valid = jnp.where(offs >= 0, 1.0, 0.0)[None, :]    # [1, NP]
    offs = jnp.maximum(offs, 0)[None, :]

    def row(k):
        return c_ref[k, :]                             # [BP]

    midx, midy = row(MID_X), row(MID_Y)
    offx, offy = row(OFF_X), row(OFF_Y)
    p0x, p0y = row(P0_X), row(P0_Y)
    started = row(STARTED)

    def sample(px, py, rounded):
        """Bilinear ps x ps sample at mid + p: [BP, NP] (zero on pad)."""
        mx = (midx + px) + offx
        my = (midy + py) + offy
        fx = jnp.floor(mx)
        fy = jnp.floor(my)
        rx = (mx - fx)[:, None]
        ry = (my - fy)[:, None]
        # lax.dynamic_slice semantics: a negative start wraps once, then
        # the start is clamped so the (ps+1)^2 window stays in the image
        sy = fy.astype(jnp.int32) + off0
        sx = fx.astype(jnp.int32) + off0
        sy = jnp.clip(jnp.where(sy < 0, sy + Hp, sy), 0, Hp - K)
        sx = jnp.clip(jnp.where(sx < 0, sx + Wp, sx), 0, Wp - K)
        idx = (sy * WpC + sx * C)[:, None] + offs

        def tap(i):
            v = img_ref[i].astype(f32)
            if rounded:
                v = v.astype(jnp.bfloat16).astype(f32)
            return v

        s = ((1.0 - rx) * (1.0 - ry) * tap(idx)
             + rx * (1.0 - ry) * tap(idx + C)
             + (1.0 - rx) * ry * tap(idx + WpC)
             + rx * ry * tap(idx + WpC + C))
        return s * valid

    def step(_, carry):
        px, py, act = carry
        S = sample(px, py, bf16_samples)
        m = jnp.sum(S, axis=1) / n_vals * mean_on
        dpx = (jnp.sum(S * w_ref[1, :, :], axis=1) - m * row(GX_SUM)
               - row(GX_T))
        dpy = (jnp.sum(S * w_ref[2, :, :], axis=1) - m * row(GY_SUM)
               - row(GY_T))
        h00, h01, h11, det = row(H00), row(H01), row(H11), row(DET)
        px_new = px - (h11 * dpx - h01 * dpy) / det
        py_new = py - (h00 * dpy - h01 * dpx) / det
        mx_new = midx + px_new
        my_new = midy + py_new
        dx = mx_new - midx
        dy = my_new - midy
        norm = jnp.sqrt(dx * dx + dy * dy)
        outlier = ((norm > thresh) | (mx_new < l_bound) | (my_new < l_bound)
                   | (mx_new > ub_w) | (my_new > ub_h))
        px_new = jnp.where(outlier, p0x, px_new)
        py_new = jnp.where(outlier, p0y, py_new)
        on = act > 0.0
        return (jnp.where(on, px_new, px), jnp.where(on, py_new, py),
                jnp.where(outlier, 0.0, act))

    px, py, _ = jax.lax.fori_loop(0, n_iters, step,
                                  (row(P_X), row(P_Y), started))
    S = sample(px, py, False)
    m = jnp.sum(S, axis=1) / n_vals * mean_on
    d = (S - m[:, None]) - w_ref[0, :, :]
    d_ref[...] = jnp.where(started[:, None] > 0.0, d * valid, 0.0)
    p_ref[0, :] = px
    p_ref[1, :] = py


def gn_solve(img_flat: jax.Array, offs: jax.Array, consts: jax.Array,
             w: jax.Array, *, n_iters: int, ps: int, C: int, Hp: int,
             Wp: int, padding: int, thresh: float, l_bound: float,
             ub_w: float, ub_h: float, mean_on: float,
             bf16_samples: bool = False, interpret: bool = False):
    """Run one scale's full Gauss-Newton solve.

    img_flat: [Hp*Wp*C] padded level image (float32), flattened.
    offs:     [NP] int32 tap offsets of each patch pixel relative to the
              window's top-left corner; -1 marks padding lanes.
    consts:   [32, Pp] per-patch constants (rows named above); Pp is a
              multiple of :func:`block_patches`.
    w:        [3, Pp, NP] template, gx, gy per patch pixel (zero padded).
    Returns (p [2, Pp] final flow, diff [Pp, NP] final signed residual,
    zero for patches never started and on padding lanes).
    """
    NP = offs.shape[0]
    Pp = consts.shape[1]
    BP = block_patches(NP)
    assert Pp % BP == 0, (Pp, BP)
    kern = functools.partial(
        _kernel, n_iters=n_iters, ps=ps, C=C, Hp=Hp, Wp=Wp, padding=padding,
        thresh=thresh, l_bound=l_bound, ub_w=ub_w, ub_h=ub_h,
        mean_on=mean_on, n_vals=float(ps * ps * C),
        bf16_samples=bf16_samples)
    return pl.pallas_call(
        kern,
        grid=(Pp // BP,),
        out_shape=(jax.ShapeDtypeStruct((2, Pp), jnp.float32),
                   jax.ShapeDtypeStruct((Pp, NP), jnp.float32)),
        in_specs=[pl.BlockSpec(img_flat.shape, lambda i: (0,)),
                  pl.BlockSpec((NP,), lambda i: (0,)),
                  pl.BlockSpec((N_CONST, BP), lambda i: (0, i)),
                  pl.BlockSpec((3, BP, NP), lambda i: (0, i, 0))],
        out_specs=(pl.BlockSpec((2, BP), lambda i: (0, i)),
                   pl.BlockSpec((BP, NP), lambda i: (i, 0))),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="dis_gn_solve",
    )(img_flat, offs, consts, w)
