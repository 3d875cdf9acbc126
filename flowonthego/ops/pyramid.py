"""Image & gradient pyramid construction.

Behavioral equivalent of the reference's NPP pipeline
(src/kernels/pyramid.cpp:32-223):

  per level:  downsample x0.5 (bilinear)  ->  central-difference gradients
              (1D kernel {1,0,-1}, replicate border; the reference's
              "sobel" is cv::Sobel with ksize=1, i.e. a plain central
              difference with NO 1/2 factor — kroeger/run_dense.cpp:140)
              ->  replicate-pad the image / zero-pad the gradients by
              ``padding`` on every side.

Design notes:
  * The x0.5 bilinear resize with half-pixel centers degenerates to 2x2
    average pooling for even dims (guaranteed by the divisibility padding,
    src/run_dense.cpp:231-253) — implemented as a reshape-mean, which XLA
    fuses into a single memory-bound pass; no gather.
  * Gradients are shifted-slice subtractions on the replicate-padded
    array — pure elementwise, fused by XLA.
  * All levels stay device-resident; nothing round-trips to host.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp


class PyramidLevel(NamedTuple):
    """One pyramid level, each array [H + 2p, W + 2p, C] (padded)."""
    image: jax.Array      # replicate-padded image
    grad_x: jax.Array     # zero-padded d/dx
    grad_y: jax.Array     # zero-padded d/dy


def pad_replicate(img: jax.Array, pad: int | tuple) -> jax.Array:
    """Replicate-pad spatial dims of [H, W, C] (NPP CopyReplicateBorder)."""
    if isinstance(pad, int):
        pad_cfg = ((pad, pad), (pad, pad), (0, 0))
    else:
        (pt, pb, pl, pr) = pad
        pad_cfg = ((pt, pb), (pl, pr), (0, 0))
    return jnp.pad(img, pad_cfg, mode="edge")


def pad_constant(img: jax.Array, pad: int, value: float = 0.0) -> jax.Array:
    """Constant-pad spatial dims of [H, W, C] (NPP CopyConstBorder)."""
    return jnp.pad(img, ((pad, pad), (pad, pad), (0, 0)),
                   mode="constant", constant_values=value)


def central_diff(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Central-difference gradients with replicate border.

    gx[y, x] = I[y, x+1] - I[y, x-1];  gy likewise vertically.
    Matches NPP FilterRow/ColumnBorder with kernel {1,0,-1} (true
    convolution => taps reversed) and NPP_BORDER_REPLICATE
    (src/kernels/pyramid.cpp:80-105), which equals cv::Sobel ksize=1
    (kroeger/run_dense.cpp:140-141).  No 1/2 normalization.
    """
    xpad = jnp.pad(img, ((0, 0), (1, 1), (0, 0)), mode="edge")
    gx = xpad[:, 2:, :] - xpad[:, :-2, :]
    ypad = jnp.pad(img, ((1, 1), (0, 0), (0, 0)), mode="edge")
    gy = ypad[2:, :, :] - ypad[:-2, :, :]
    return gx, gy


def _pool2x2(x: jax.Array, C: int) -> jax.Array:
    """2x2 mean of a flat [h, w*C] view; an odd trailing row or column is
    dropped (``VALID`` pooling).  A reshape and a sum over the two pair
    axes: one memory-bound fusion that reads the level once."""
    h, w = x.shape[0] // 2, x.shape[1] // (2 * C)
    x = x[:2 * h, :2 * w * C].reshape(h, 2, w, 2, C)
    return (x.sum(axis=(1, 3)) * 0.25).reshape(h, w * C)


def downsample_half(img: jax.Array) -> jax.Array:
    """Bilinear x0.5 downsample == 2x2 average pool (even dims).

    NPP ResizeSqrPixel / cv::resize INTER_LINEAR at scale 0.5 with
    half-pixel centers sample the average of each 2x2 block
    (src/kernels/pyramid.cpp:151-155, kroeger/run_dense.cpp:150).
    """
    h, w, C = img.shape
    return _pool2x2(img.reshape(h, w * C), C).reshape(h // 2, w // 2, C)


def _downsample_half_flat(x: jax.Array, C: int, bias=None) -> jax.Array:
    """2x2 average pool on the flat [H, W*C] view.

    A uint8 frame is upcast inside the pool's read, so the dominant
    full-resolution pass moves a quarter of the bytes.  ``bias``: optional
    traced scalar added to the input inside the pool (result == pooling
    ``x + bias``); fuses a streaming caller's frame ingest into the
    level's read instead of a standalone full-frame add.
    """
    if x.dtype != jnp.float32:
        x = x.astype(jnp.float32)
    if bias is not None:
        x = x + bias
    return _pool2x2(x, C)


def build_pyramid(img: jax.Array, n_levels: int, padding: int,
                  start_level: int = 0,
                  ingest_bias=None) -> List[PyramidLevel]:
    """Build ``n_levels`` levels (level 0 = full res) of image+gradient
    pyramids, padded for patch addressing.

    Equivalent of cu::constructImgPyramids (src/kernels/pyramid.cpp:32-223).
    ``img`` is [H, W, C] float; H and W must be divisible by
    ``2**(n_levels-1)``.

    Levels below ``start_level`` (finer than the finest processed scale)
    exist only to feed the downsample chain: they get no gradients and no
    padding (their ``image`` is the raw level, ``grad_* = None``).  At the
    reference's operating points this skips all full-resolution gradient/
    padding passes — the dominant cost at 4K.

    ``ingest_bias``: optional traced scalar; the pyramid equals
    ``build_pyramid(img + ingest_bias, ...)`` but the add is fused into
    the first downsample's read (streamed-video ingest).  Requires
    ``start_level >= 1``: levels below ``start_level`` store the PRE-bias
    image (they only feed the downsample chain, which applies the bias),
    and with ``start_level == 0`` the full-res level would be consumed
    un-biased.
    """
    H, W, C = img.shape
    if ingest_bias is not None and start_level < 1:
        raise ValueError("ingest_bias requires start_level >= 1 (the "
                         "full-resolution level would miss the bias)")
    if img.dtype == jnp.uint8 and start_level < 1:
        # the full-res level feeds gradients/padding directly — upcast
        # here; with start_level >= 1 the first pool fuses the upcast
        # into its own read (1/4 the bytes on the dominant 4K pass)
        img = img.astype(jnp.float32)
    levels = []
    # The downsample chain runs on the flat [h, w*C] view end to end.
    cur = img.reshape(H, W * C)
    for lvl in range(n_levels):
        if lvl > 0:
            cur = _downsample_half_flat(
                cur, C, bias=ingest_bias if lvl == 1 else None)
        h, w = H >> lvl, W >> lvl
        if lvl < start_level:
            levels.append(PyramidLevel(image=cur.reshape(h, w, C),
                                       grad_x=None, grad_y=None))
            continue
        current = cur.reshape(h, w, C)
        gx, gy = central_diff(current)
        levels.append(PyramidLevel(
            image=pad_replicate(current, padding),
            grad_x=pad_constant(gx, padding),
            grad_y=pad_constant(gy, padding),
        ))
    return levels
