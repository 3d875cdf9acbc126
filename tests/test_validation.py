"""API-boundary input validation: malformed pairs fail fast with clear
errors instead of surfacing as shape errors deep inside XLA.

(The reference CLI fails at image load on a bad pair,
run_dense.cpp:137-151; the library API deserves the same property.)
"""

import numpy as np
import pytest

from flowonthego.config import DISConfig
from flowonthego.models.dis_flow import compute_flow, validate_image_pair
from flowonthego.models.stereo import compute_disparity
from flowonthego.parallel.frame_parallel import stream_flow

CFG = DISConfig(coarsest_scale=3, finest_scale=1, grad_descent_iter=2,
                use_var_ref=False)


def _img(h=32, w=48, c=3):
    return np.random.default_rng(0).random((h, w, c)).astype(np.float32)


def test_compute_flow_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="pair shapes differ"):
        compute_flow(_img(32, 48), _img(32, 40), cfg=CFG)


def test_compute_flow_rejects_wrong_rank():
    with pytest.raises(ValueError, match="3-dimensional"):
        compute_flow(_img()[:, :, 0], _img()[:, :, 0], cfg=CFG)


def test_compute_flow_rejects_bad_channel_count():
    with pytest.raises(ValueError, match="channels"):
        compute_flow(_img(c=4), _img(c=4), cfg=CFG)


def test_compute_disparity_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="pair shapes differ"):
        compute_disparity(_img(32, 48), _img(40, 48), cfg=CFG)


def test_stream_flow_rejects_mid_stream_shape_change():
    frames = [_img(32, 48), _img(32, 48), _img(32, 40)]
    with pytest.raises(ValueError, match="shape changed"):
        list(stream_flow(iter(frames), CFG))


def test_stream_flow_rejects_unpadded_frames():
    with pytest.raises(ValueError, match="divisibility"):
        list(stream_flow(iter([_img(33, 48)]), CFG))


def test_validate_accepts_gray_and_rgb():
    validate_image_pair(_img(c=1), _img(c=1))
    validate_image_pair(_img(c=3), _img(c=3))
