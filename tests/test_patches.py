"""Patch grid geometry + extraction vs numpy oracles
(semantics of src/patchgrid.cpp:42-63 and src/kernels/extract.cu:43-122)."""

import numpy as np
import jax.numpy as jnp

from flowonthego.config import DISConfig
from flowonthego.ops.patches import (PatchGrid, extract_windows,
                                     extract_templates_and_hessians)
from flowonthego.ops.pyramid import pad_replicate, pad_constant, central_diff


def test_grid_geometry_reference_values():
    # 1024-wide scale-3 level of the Sintel case: 128 x 56, steps 4
    cfg = DISConfig(patch_size=8, patch_stride=0.4)
    assert cfg.steps == 4
    g = PatchGrid.create(cfg, 128, 56)
    assert (g.n_w, g.n_h) == (32, 14)
    assert (g.offset_w, g.offset_h) == (2, 2)  # floor((dim-(n-1)*steps)/2)
    mx, my = g.midpoints()
    assert mx[0, 0] == 2 and my[0, 0] == 2
    assert mx[0, -1] == 2 + 31 * 4
    # bounds (src/oflow.cpp:90-92)
    assert g.l_bound == -4.0
    assert g.u_bound_w == 128 + 4 - 2
    assert g.u_bound_h == 56 + 4 - 2


def test_extract_windows_matches_loop(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4)
    h, w = 24, 32
    img = rng.standard_normal((h, w, 3)).astype(np.float32)
    pad = cfg.padding
    img_pad = np.asarray(pad_replicate(jnp.asarray(img), pad))
    grid = PatchGrid.create(cfg, w, h)
    wins = np.asarray(extract_windows(jnp.asarray(img_pad), grid))
    mx, my = grid.midpoints()
    ps = cfg.patch_size
    for gy in range(grid.n_h):
        for gx in range(grid.n_w):
            x = int(mx[gy, gx]) + pad
            y = int(my[gy, gx]) + pad
            ref = img_pad[y - ps // 2: y + ps // 2, x - ps // 2: x + ps // 2]
            np.testing.assert_array_equal(wins[gy, gx], ref)


def test_templates_mean_normalized_and_hessian(rng):
    cfg = DISConfig(patch_size=8, patch_stride=0.4)
    h, w = 16, 16
    img = rng.standard_normal((h, w, 3)).astype(np.float32)
    gx_img, gy_img = central_diff(jnp.asarray(img))
    pad = cfg.padding
    I0 = pad_replicate(jnp.asarray(img), pad)
    I0x = pad_constant(gx_img, pad)
    I0y = pad_constant(gy_img, pad)
    grid = PatchGrid.create(cfg, w, h)
    tmpl, tgx, tgy, H = extract_templates_and_hessians(I0, I0x, I0y, grid, cfg)
    tmpl, tgx, tgy, H = map(np.asarray, (tmpl, tgx, tgy, H))

    # templates are mean-normalized over all 3*ps^2 values (extract.cu:79-96)
    np.testing.assert_allclose(tmpl.mean(axis=(2, 3, 4)), 0.0, atol=1e-5)
    # Hessian = gradient outer-product sums (extract.cu:99-118)
    np.testing.assert_allclose(H[..., 0], (tgx * tgx).sum((2, 3, 4)),
                               rtol=1e-5)
    np.testing.assert_allclose(H[..., 1], (tgx * tgy).sum((2, 3, 4)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(H[..., 2], (tgy * tgy).sum((2, 3, 4)),
                               rtol=1e-5)
