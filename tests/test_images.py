"""Binary PPM/PGM image I/O without PIL (io/images.py)."""

import builtins

import numpy as np
import pytest

from flowonthego.io.images import load_image, save_image


@pytest.mark.parametrize("ext,shape", [(".ppm", (5, 7, 3)),
                                       (".pgm", (6, 4)),
                                       (".pnm", (3, 8, 3))])
def test_netpbm_roundtrip(tmp_path, rng, ext, shape):
    img = (rng.random(shape) * 255).astype(np.uint8)
    path = tmp_path / f"x{ext}"
    save_image(path, img)
    back = load_image(path)
    assert back.dtype == np.float32 and back.shape == shape[:2] + (3,)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(back, want.astype(np.float32))


def test_ppm_is_rgb_on_disk_bgr_in_memory(tmp_path):
    bgr = np.zeros((1, 1, 3), np.float32)
    bgr[0, 0] = (10, 20, 30)                   # B, G, R
    save_image(tmp_path / "c.ppm", bgr)
    raw = (tmp_path / "c.ppm").read_bytes()
    assert raw.startswith(b"P6\n1 1\n255\n") and raw[-3:] == bytes([30, 20, 10])
    np.testing.assert_array_equal(load_image(tmp_path / "c.ppm")[0, 0],
                                  [10, 20, 30])


def test_header_comments_and_16_bit(tmp_path):
    data = np.array([[1, 65535]], ">u2")
    (tmp_path / "c.pgm").write_bytes(b"P5 # a comment\n2 # w\n1\n65535\n"
                                     + data.tobytes())
    np.testing.assert_array_equal(load_image(tmp_path / "c.pgm")[0, :, 0],
                                  [1, 65535])


def test_other_formats_name_pil_when_absent(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PPM/PGM"):
        save_image(tmp_path / "x.png", np.zeros((2, 2, 3), np.uint8))
    (tmp_path / "y.png").write_bytes(b"\x89PNG....")
    with pytest.raises(ImportError, match="PIL"):
        load_image(tmp_path / "y.png")
