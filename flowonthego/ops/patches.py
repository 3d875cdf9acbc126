"""Patch grid geometry, template extraction and Gauss-Newton Hessians.

Redesign of the reference's per-patch pointer scheme
(src/patchgrid.cpp:35-194 allocates ~8 device buffers per
patch and launches one CUDA block per patch): here the whole grid is a
handful of dense tensors shaped [n_h, n_w, ...] and extraction is a single
static strided-window op that XLA lowers to cheap slices — no gathers, no
per-patch anything.

Geometry (matches src/patchgrid.cpp:42-63):
    steps        = floor(patch_size * (1 - patch_stride))   (>=1)
    n_w          = ceil(width / steps),  n_h = ceil(height / steps)
    offset_w     = floor((width  - (n_w - 1) * steps) / 2)
    offset_h     = floor((height - (n_h - 1) * steps) / 2)
    midpoint[y, x] = (x * steps + offset_w, y * steps + offset_h)  (ints)

Patches are patch_size x patch_size, centered so that pixel rows
[mid - ps/2, mid + ps/2) are covered (extract.cu:63-64).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DISConfig


@dataclasses.dataclass(frozen=True)
class PatchGrid:
    """Static patch-grid geometry for one pyramid scale."""
    width: int
    height: int
    patch_size: int
    steps: int
    n_w: int
    n_h: int
    offset_w: int
    offset_h: int
    padding: int

    @classmethod
    def create(cls, cfg: DISConfig, width: int, height: int) -> "PatchGrid":
        steps = cfg.steps
        n_w = -(-width // steps)   # ceil
        n_h = -(-height // steps)
        offset_w = (width - (n_w - 1) * steps) // 2
        offset_h = (height - (n_h - 1) * steps) // 2
        return cls(width=width, height=height, patch_size=cfg.patch_size,
                   steps=steps, n_w=n_w, n_h=n_h, offset_w=offset_w,
                   offset_h=offset_h, padding=cfg.padding)

    @property
    def n_patches(self) -> int:
        return self.n_w * self.n_h

    def midpoints(self) -> tuple[np.ndarray, np.ndarray]:
        """Integer midpoints (mx[n_h, n_w], my[n_h, n_w]) — static numpy."""
        mx = (np.arange(self.n_w) * self.steps + self.offset_w)[None, :]
        my = (np.arange(self.n_h) * self.steps + self.offset_h)[:, None]
        return (np.broadcast_to(mx, (self.n_h, self.n_w)).astype(np.float32),
                np.broadcast_to(my, (self.n_h, self.n_w)).astype(np.float32))

    # Bounds for the patch-midpoint box constraint (src/oflow.cpp:90-92).
    @property
    def l_bound(self) -> float:
        return -float(self.patch_size) / 2.0

    @property
    def u_bound_w(self) -> float:
        return float(self.width + self.patch_size // 2 - 2)

    @property
    def u_bound_h(self) -> float:
        return float(self.height + self.patch_size // 2 - 2)


def extract_windows(img_pad: jax.Array, grid: PatchGrid) -> jax.Array:
    """All template windows as one tensor [n_h, n_w, ps, ps, C].

    window[y, x, r, c] = img_pad[pad + my - ps/2 + r, pad + mx - ps/2 + c]
    — the strided copy of kernelExtractPatchesAndHessians
    (extract.cu:60-74), done for every patch at once with static slices.
    """
    ps, st = grid.patch_size, grid.steps
    C = img_pad.shape[2]
    top = grid.padding + grid.offset_h - ps // 2
    left = grid.padding + grid.offset_w - ps // 2
    rows = (grid.n_h - 1) * st + ps
    cols = (grid.n_w - 1) * st + ps
    region = jax.lax.slice(img_pad, (top, left, 0),
                           (top + rows, left + cols, C))
    if ps % st == 0:
        # Grouped form (all standard operating points have ps = 2*st):
        # windows are k^2 contiguous reshaped tilings, so the whole
        # extraction is 2k slices + 2 concats + 1 transpose instead of
        # ps^2 strided slices + a ps^2-way stack.
        k = ps // st
        T = region.reshape(grid.n_h - 1 + k, st, cols, C)
        rows_st = jnp.concatenate([T[a:a + grid.n_h] for a in range(k)],
                                  axis=1)                 # [n_h, ps, cols, C]
        X = rows_st.reshape(grid.n_h, ps, grid.n_w - 1 + k, st, C)
        cols_st = jnp.concatenate([X[:, :, b:b + grid.n_w] for b in range(k)],
                                  axis=3)            # [n_h, ps, n_w, ps, C]
        return cols_st.transpose(0, 2, 1, 3, 4)
    # Fallback: gather the ps*ps static shifts as strided slices.
    shifted = [
        region[r:r + (grid.n_h - 1) * st + 1:st,
               c:c + (grid.n_w - 1) * st + 1:st, :]
        for r in range(ps) for c in range(ps)
    ]
    stacked = jnp.stack(shifted, axis=2)  # [n_h, n_w, ps*ps, C]
    return stacked.reshape(grid.n_h, grid.n_w, ps, ps, C)


def extract_templates_and_hessians(
        I0_pad: jax.Array, I0x_pad: jax.Array, I0y_pad: jax.Array,
        grid: PatchGrid, cfg: DISConfig):
    """Extract mean-normalized templates, gradients, and 2x2 GN Hessians.

    Equivalent of kernelExtractPatchesAndHessians (extract.cu:43-122):
      * template = window(I0) - mean(window(I0))      (over all 3*ps^2 vals)
      * H = [[sum gx^2, sum gx gy], [sum gx gy, sum gy^2]]; if det == 0 the
        diagonal gets +1e-10 (extract.cu:110-113).

    Returns (templates, tgrad_x, tgrad_y, H) with shapes
    [n_h, n_w, ps, ps, C] x3 and [n_h, n_w, 3] (H00, H01, H11).
    """
    templates = extract_windows(I0_pad, grid)
    gx = extract_windows(I0x_pad, grid)
    gy = extract_windows(I0y_pad, grid)

    if cfg.use_mean_normalization:
        mean = templates.mean(axis=(2, 3, 4), keepdims=True)
        templates = templates - mean

    h00 = (gx * gx).sum(axis=(2, 3, 4))
    h01 = (gx * gy).sum(axis=(2, 3, 4))
    h11 = (gy * gy).sum(axis=(2, 3, 4))
    det = h00 * h11 - h01 * h01
    bump = jnp.where(det == 0.0, 1e-10, 0.0).astype(h00.dtype)
    H = jnp.stack([h00 + bump, h01, h11 + bump], axis=-1)
    return templates, gx, gy, H
