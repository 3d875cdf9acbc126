"""Float32 contractions that must not run in TF32 on the GPU: the GN
reduction matvec (ops/dis.py) and the full-resolution flow upsample
(ops/resize.py).  Each is pinned to HIGHEST precision in its jaxpr and
checked against a float64 numpy oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from flowonthego.config import DISConfig
from flowonthego.ops import dis as dis_mod
from flowonthego.ops.patches import PatchGrid, extract_templates_and_hessians
from flowonthego.ops.pyramid import central_diff, pad_constant, pad_replicate
from flowonthego.ops.resize import _interp_matrix, resize_matmul


def _dot_precisions(closed) -> list:
    """``precision`` of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)
    walk(closed.jaxpr)
    return out


def _all_highest(precs) -> bool:
    hi = jax.lax.Precision.HIGHEST
    return bool(precs) and all(p is not None and all(x == hi for x in p)
                               for p in precs)


def test_resize_matmul_is_highest_and_matches_float64(rng):
    flow = (rng.standard_normal((14, 32, 2)) * 60).astype(np.float32)
    precs = _dot_precisions(jax.make_jaxpr(
        lambda f: resize_matmul(f, 56, 128))(flow))
    assert len(precs) == 2 and _all_highest(precs), precs
    got = np.asarray(resize_matmul(jnp.asarray(flow), 56, 128))
    Rv = _interp_matrix(56, 14).astype(np.float64)
    Rh = _interp_matrix(128, 32).astype(np.float64)
    ref = np.einsum("pw,owc->opc", Rh,
                    np.einsum("oh,hwc->owc", Rv, flow.astype(np.float64)))
    # f32 rounding of ~100 px values: ~1e-5 px; TF32 would be ~0.1 px
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_gn_reduction_is_highest_and_matches_float64(rng):
    from scipy.ndimage import gaussian_filter
    cfg = DISConfig(coarsest_scale=0, finest_scale=0, grad_descent_iter=1,
                    gn_backend="xla")
    img = gaussian_filter(rng.standard_normal((32, 40, 3)),
                          (2, 2, 0)).astype(np.float32) * 120 + 128
    grid = PatchGrid.create(cfg, 40, 32)
    gx, gy = central_diff(jnp.asarray(img))
    st = dis_mod.init_state(*extract_templates_and_hessians(
        pad_replicate(jnp.asarray(img), cfg.padding),
        pad_constant(gx, cfg.padding), pad_constant(gy, cfg.padding),
        grid, cfg), grid)
    I1p = pad_replicate(jnp.asarray(np.roll(img, 1, axis=1)), cfg.padding)
    precs = _dot_precisions(jax.make_jaxpr(lambda s, i: dis_mod.optimize(
        s, i, grid, cfg))(st, I1p))
    assert _all_highest(precs), precs

    # one Gauss-Newton step in float64 from the same windows
    got = np.asarray(dis_mod.optimize(st, I1p, grid, cfg).p_cur, np.float64)
    ps, pad = cfg.patch_size, cfg.padding
    I1 = np.asarray(I1p, np.float64)
    mid = np.asarray(st.mid_org, np.float64)
    T = np.asarray(st.templates, np.float64)
    GX = np.asarray(st.tgrad_x, np.float64)
    GY = np.asarray(st.tgrad_y, np.float64)
    Hs = np.asarray(st.H, np.float64)
    for (j, i) in [(0, 0), (1, 2), (2, 3)]:
        mx, my = mid[j, i]
        x0, y0 = int(np.floor(mx)), int(np.floor(my))
        rx, ry = mx - x0, my - y0
        sy, sx = y0 + pad - ps // 2, x0 + pad - ps // 2
        W = I1[sy:sy + ps + 1, sx:sx + ps + 1]
        S = ((1 - rx) * (1 - ry) * W[:ps, :ps] + rx * (1 - ry) * W[:ps, 1:]
             + (1 - rx) * ry * W[1:, :ps] + rx * ry * W[1:, 1:])
        d = (S - S.mean()) - T[j, i]
        dpx, dpy = (GX[j, i] * d).sum(), (GY[j, i] * d).sum()
        h00, h01, h11 = Hs[j, i]
        det = h00 * h11 - h01 * h01
        want = -np.array([(h11 * dpx - h01 * dpy) / det,
                          (h00 * dpy - h01 * dpx) / det])
        np.testing.assert_allclose(got[j, i], want, rtol=1e-4, atol=1e-4)
