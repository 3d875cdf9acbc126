"""Image loading/saving for the flow engine.

The reference uses OpenCV ``imread`` + ``convertTo(CV_32F)``
(src/run_dense.cpp:137-145): images are loaded as **BGR** uint8 and
converted to float32 *without scaling* (values in [0, 255]).  We
reproduce those numerics (BGR channel order, 0..255 floats) so flow
fields are directly comparable with the reference's outputs.

Binary PPM (P6) and PGM (P5) are read and written with numpy alone;
other formats (PNG, JPEG, ...) need PIL.
"""

from __future__ import annotations

import os

import numpy as np

_NETPBM = {".ppm": b"P6", ".pgm": b"P5", ".pnm": None}


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading or writing this image format needs PIL (pillow); "
            "binary PPM/PGM files work without it") from e
    return Image


def _read_netpbm(path) -> np.ndarray:
    """Binary P5/P6 -> uint8 or uint16 [H, W, C] in file (RGB) order."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":          # comment to end of line
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), \
        int(fields[3])
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM/PPM (magic {magic!r})")
    C = 3 if magic == b"P6" else 1
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    pos += 1                                    # one whitespace byte
    n = h * w * C
    arr = np.frombuffer(data, dtype, count=n, offset=pos)
    return arr.reshape(h, w, C)


def load_image(path: str | os.PathLike) -> np.ndarray:
    """Load an image as float32 [H, W, 3] in BGR order, values 0..255."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"P5", b"P6"):
        rgb = _read_netpbm(path).astype(np.float32)
        if rgb.shape[-1] == 1:
            rgb = np.repeat(rgb, 3, axis=-1)
    else:
        img = _pil().open(path).convert("RGB")
        rgb = np.asarray(img, dtype=np.float32)
    return rgb[..., ::-1].copy()  # RGB -> BGR to match cv::imread


def save_image(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save a float32 BGR [H, W, 3] (0..255) or uint8 image to disk.

    ``.ppm`` / ``.pgm`` (and ``.pnm``, by channel count) are written as
    binary netpbm with numpy; other extensions go through PIL.
    """
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr[..., ::-1]  # BGR -> RGB
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext not in _NETPBM:
        _pil().fromarray(arr).save(path)
        return
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    magic = b"P6" if arr.ndim == 3 else b"P5"
    if _NETPBM[ext] not in (None, magic):
        raise ValueError(f"{path}: {ext} needs "
                         f"{'3' if ext == '.ppm' else '1'} channel(s), got "
                         f"shape {arr.shape}")
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(arr).tobytes())
