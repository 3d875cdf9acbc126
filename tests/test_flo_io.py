"""Middlebury .flo / PFM I/O tests (format per flow_code/C/flowIO.cpp:5-45)."""

import numpy as np

from flowonthego.io.flo import read_flo, write_flo, TAG_STRING
from flowonthego.io.pfm import read_pfm, write_pfm
from flowonthego.io.color import flow_to_color


def test_flo_roundtrip(tmp_path, rng):
    flow = rng.standard_normal((7, 13, 2)).astype(np.float32)
    path = tmp_path / "t.flo"
    write_flo(path, flow)
    out = read_flo(path)
    np.testing.assert_array_equal(out, flow)


def test_flo_header_bytes(tmp_path):
    flow = np.zeros((2, 3, 2), np.float32)
    path = tmp_path / "t.flo"
    write_flo(path, flow)
    raw = path.read_bytes()
    assert raw[:4] == TAG_STRING            # float 202021.25 == b"PIEH"
    assert np.frombuffer(raw[4:12], np.int32).tolist() == [3, 2]
    assert len(raw) == 12 + 2 * 3 * 2 * 4


def test_read_bundled_reference_flow(tmp_path):
    """A .flo written byte by byte as the Middlebury spec lays it out
    (tag, width, height, then row-major interleaved u, v float32) reads
    back at the right shape and values."""
    h, w = 3, 4
    u = np.arange(h * w, dtype=np.float32).reshape(h, w) * 0.5
    v = -u - 1.0
    body = np.stack([u, v], -1).astype("<f4").tobytes()
    header = b"PIEH" + b"\x04\x00\x00\x00" + b"\x03\x00\x00\x00"
    path = tmp_path / "golden.flo"
    path.write_bytes(header + body)
    flow = read_flo(path)
    assert flow.shape == (h, w, 2) and flow.dtype == np.float32
    np.testing.assert_array_equal(flow[..., 0], u)
    np.testing.assert_array_equal(flow[..., 1], v)
    # and the writer reproduces those exact bytes
    write_flo(tmp_path / "again.flo", flow)
    assert (tmp_path / "again.flo").read_bytes() == header + body


def test_pfm_roundtrip(tmp_path, rng):
    img = rng.standard_normal((5, 9)).astype(np.float32)
    path = tmp_path / "t.pfm"
    write_pfm(path, img)
    np.testing.assert_array_equal(read_pfm(path), img)

    rgb = rng.standard_normal((4, 6, 3)).astype(np.float32)
    write_pfm(path, rgb)
    np.testing.assert_array_equal(read_pfm(path), rgb)


def test_flow_to_color_shapes():
    flow = np.zeros((8, 8, 2), np.float32)
    flow[..., 0] = 1.0
    rgb = flow_to_color(flow)
    assert rgb.shape == (8, 8, 3) and rgb.dtype == np.uint8
    # uniform flow -> uniform color
    assert (rgb == rgb[0, 0]).all()
