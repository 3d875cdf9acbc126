"""Multi-chip streamed video (parallel/multistream.py) on the fake mesh.

The claim under test: N warm-started streams sharded over 'data' produce
EXACTLY the flows of N sequential single-device stream_flow runs — the
pipeline is per-stream local (zero collectives), so sharding must not
change the numbers beyond vmap's fp-reassociation noise (measured 0 on
CPU; a loose cap guards device reductions).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flowonthego.config import DISConfig
from flowonthego.parallel import make_mesh
from flowonthego.parallel.frame_parallel import stream_flow
from flowonthego.parallel.multistream import (MultiStream,
                                              stream_video_chunks)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

CFG = DISConfig(coarsest_scale=3, finest_scale=1, grad_descent_iter=4,
                use_var_ref=True)
H, W, T = 48, 64, 4


def _sequences(rng, n_streams):
    """[N, T, H, W, 3] smooth drifting sequences, distinct per stream."""
    from scipy.ndimage import gaussian_filter
    seqs = np.empty((n_streams, T, H, W, 3), np.float32)
    for b in range(n_streams):
        base = gaussian_filter(
            rng.standard_normal((H + 16, W + 16, 3)).astype(np.float32),
            sigma=(3, 3, 0)) * 120 + 128
        for t in range(T):
            dy, dx = (t * (1 + b % 3)) % 8, (t * (2 + b % 2)) % 8
            seqs[b, t] = base[dy:dy + H, dx:dx + W]
    return seqs


@pytest.mark.slow    # the 8-device dryrun asserts exactly this
# equivalence every driver round (program 4); kept as a slow regression
def test_multistream_matches_sequential_streams(rng):
    mesh = make_mesh(n_data=8, n_space=1)
    seqs = _sequences(rng, 8)

    ms = MultiStream(mesh, CFG, H, W)
    ms.start(seqs[:, 0])
    got = np.stack([np.asarray(ms.push(seqs[:, t])) for t in range(1, T)],
                   axis=1)                      # [N, T-1, H, W, 2]

    for b in range(8):
        want = list(stream_flow(iter(seqs[b]), CFG))
        for t in range(T - 1):
            np.testing.assert_allclose(got[b, t], want[t], atol=5e-5,
                                       err_msg=f"stream {b} pair {t}")


def test_multistream_shards_over_data_axis(rng):
    """State and outputs actually live sharded over the 8 devices."""
    mesh = make_mesh(n_data=8, n_space=1)
    seqs = _sequences(rng, 8)
    ms = MultiStream(mesh, CFG, H, W)
    ms.start(seqs[:, 0])
    out = ms.push(seqs[:, 1])
    assert len(out.sharding.device_set) == 8
    # every carried pyramid level is sharded too (per-chip stream state)
    leaves = jax.tree.leaves(ms._state)
    assert leaves and all(len(x.sharding.device_set) == 8 for x in leaves)


def test_multistream_input_validation(rng):
    mesh = make_mesh(n_data=8, n_space=1)
    ms = MultiStream(mesh, CFG, H, W)
    with pytest.raises(RuntimeError):
        ms.push(np.zeros((8, H, W, 3), np.float32))
    with pytest.raises(ValueError):
        ms.start(np.zeros((4, H, W, 3), np.float32))   # wrong batch size
    with pytest.raises(ValueError):
        ms.start(np.zeros((8, H, W + 2, 3), np.float32))
    with pytest.raises(ValueError):
        MultiStream(mesh, CFG, H + 1, W)               # not divisible


def test_chunked_video_matches_per_chunk_streams(rng):
    """One video split into 8 warm-started chunks == running a sequential
    stream_flow over each chunk's frames (chunk k's warm-start chain
    restarts at its first frame — the documented splice semantics)."""
    mesh = make_mesh(n_data=8, n_space=1)
    from scipy.ndimage import gaussian_filter
    Tv = 9   # 8 chunks of 1 pair each: splice semantics still exercised
    base = gaussian_filter(
        rng.standard_normal((H + 40, W + 40, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    video = np.stack([base[2 * t:2 * t + H, t:t + W] for t in range(Tv)])

    got = stream_video_chunks(video, mesh, CFG)
    assert got.shape == (Tv - 1, H, W, 2)

    starts = [k * (Tv - 1) // 8 for k in range(9)]
    for k in range(8):
        lo, hi = starts[k], starts[k + 1]
        want = list(stream_flow(iter(video[lo:hi + 1]), CFG))
        assert len(want) == hi - lo
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[lo + i], w, atol=5e-5,
                                       err_msg=f"chunk {k} pair {lo + i}")


def test_multistream_packs_several_streams_per_device(rng):
    """n_streams a multiple of the 'data' axis: 4 streams on a 2-device
    mesh, each equal to its own sequential stream_flow run."""
    seqs = _sequences(rng, 4)
    mesh = make_mesh(n_data=2, n_space=1, devices=jax.devices()[:2])
    ms = MultiStream(mesh, CFG, H, W, n_streams=4)
    ms.start(seqs[:, 0])
    got = [np.asarray(ms.push(seqs[:, t])) for t in range(1, T)]
    for b in range(4):
        for t, want in enumerate(stream_flow(iter(seqs[b]), CFG)):
            np.testing.assert_allclose(got[t][b], want, rtol=1e-4,
                                       atol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        MultiStream(mesh, CFG, H, W, n_streams=3)
