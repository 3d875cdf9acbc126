"""CLI contract smoke tests — every reference CLI knob reachable.

The reference exposes its full parameter surface positionally
(src/run_dense.cpp:115-227 for the 13-param GPU form,
kroeger/README.md:71-88 for the CPU 20-param form whose
extras — usefbcon / costfct / min_iter — ride dedicated flags here).
Kept compile-light: tiny frames, shallow pyramid, no var-ref.
"""

import numpy as np
import pytest

from flowonthego import cli
from flowonthego.io.flo import read_flo
from flowonthego.io.images import save_image


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    from scipy.ndimage import gaussian_filter
    base = gaussian_filter(
        rng.standard_normal((80, 112, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    a = np.clip(base[8:72, 8:104], 0, 255).astype(np.uint8)
    b = np.clip(base[6:70, 5:101], 0, 255).astype(np.uint8)
    p1, p2 = str(d / "a.png"), str(d / "b.png")
    save_image(p1, a)
    save_image(p2, b)
    return p1, p2, d


# 13-param form: cs fs gd ps stride mean var alpha gamma delta it omega verb
_PARAMS = ["3", "1", "4", "8", "0.4", "1", "0",
           "10", "10", "5", "3", "1.6", "0"]


def _run(tiny_pair, name, extra):
    p1, p2, d = tiny_pair
    out = str(d / name)
    rc = cli.main([p1, p2, out] + _PARAMS + extra)
    assert rc == 0
    flow = read_flo(out)
    assert flow.shape == (64, 96, 2) and np.isfinite(flow).all()
    return flow


def test_cli_13_param_form(tiny_pair):
    _run(tiny_pair, "plain.flo", [])


def test_cli_fb_flag(tiny_pair):
    base = _run(tiny_pair, "plain2.flo", [])
    fb = _run(tiny_pair, "fb.flo", ["--fb"])
    # usefbcon merges the backward grid's reversed flow — result differs
    assert np.abs(fb - base).max() > 1e-6


def test_cli_cost_flags(tiny_pair):
    for cost in ("l1", "huber"):
        _run(tiny_pair, f"{cost}.flo", ["--cost", cost])
    with pytest.raises(SystemExit):
        cli.main(list(tiny_pair[:2]) + ["x.flo"] + _PARAMS
                 + ["--cost", "bogus"])


def test_cli_densify_weight_flag(tiny_pair):
    _run(tiny_pair, "absw.flo", ["--densify-weight", "abs"])
    with pytest.raises(SystemExit):
        cli.main(list(tiny_pair[:2]) + ["x.flo"] + _PARAMS
                 + ["--densify-weight", "bogus"])


def test_cli_min_iter_flag(tiny_pair):
    _run(tiny_pair, "mi.flo", ["--min-iter", "2"])
