"""Run the flow pipeline once on the GPU, through its user entry points,
and check what comes out.

    python chip_smoke.py [--seed N]      # one card, phases 1-6
    python chip_smoke.py --four-cards    # the multi-card paths only

Phases (one process; every input is generated from ``--seed``):

1. device    — require a GPU; print its kind, the device count and
               nvidia-smi's name and power limit.
2. kernels   — the Pallas GN kernel compiled for the card vs the XLA loop
               at real widths (op 2 at 4K, op 4 at 1024x436), per scale;
               memory analysis of the compiled op-2 4K step.
3. compute_flow, ops 1-4 at 1024x436 (Sintel geometry): EPE against the
               generated ground truth; op 2 against the CPU backend.
4. stream_flow, op 2 at 3840x2176, 7 frames, float32 and uint8 ingest.
5. MultiStream, 4 streams of 1024x448 on a one-device mesh vs 4
               sequential stream_flow runs.
6. the CLI (``python -m flowonthego``) on a generated PPM pair.

``--four-cards`` runs MultiStream over 4 cards against 4 sequential
single-card streams, and 4K op-2 row strips (parallel/spatial_fine) over
4 cards against the unsharded pipeline.

The last line of output is one JSON object with ``"ok": true`` and the
device; any failed phase exits non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# EPE against the generated ground truth (|flow| <= 5 px).  At 1024x436
# the CPU backend measures 0.22-0.28 px for ops 1-2 and less for ops 3-4
# on the same pairs; the bound leaves room for the seed-to-seed spread.
EPE_MAX = 0.6
# op 2 at 4K stops at scale 5 (1/32 resolution): the flow is resolved on
# a 120x68 grid, where the same texture measures 0.39 px (CPU, the level-5
# images of seed 0) — a coarser result by construction.
EPE_MAX_4K = 1.0

# (height, width) of each phase's frames
SINTEL = (436, 1024)       # compute_flow, the CLI, GN kernel at op 4
UHD = (2176, 3840)         # 4K padded to 2^7: stream_flow, kernel at op 2
UHD_ROWS = 2160            # 4K rows before padding (row strips pad them)
STREAMS = (448, 1024)      # MultiStream


def log(*a):
    print(*a, flush=True)


def phase_device(want: int):
    from flowonthego.utils.device import card, require_gpu
    devs = require_gpu(want)
    name = card()
    log(f"[device] {devs[0].device_kind} x{len(devs)}; nvidia-smi: {name}")
    return devs, name


def phase_kernels(card: str):
    import jax
    from flowonthego import checks
    from flowonthego.config import operating_point
    from flowonthego.models.dis_flow import flow_full_padded

    for op, (h, w) in ((2, UHD), (4, SINTEL)):
        t0 = time.perf_counter()
        for st in checks.gn_kernel_vs_xla(op, h, w):
            log(f"[kernels] dis_gn_solve op {op} {w}x{h} scale "
                f"{st['scale']}: {st['patches']} patches, flipped "
                f"{st['flipped']}, max|dp| {st['dp_max']:.2e} px, cost rel "
                f"{st['cost_rel']:.2e}")
        log(f"[kernels] op {op}: {time.perf_counter() - t0:.1f} s incl. "
            "compile")
    cfg = operating_point(2, width=UHD[1])
    x = jax.ShapeDtypeStruct(UHD + (3,), np.float32)
    compiled = flow_full_padded.lower(x, x, cfg).compile()
    log(f"[kernels] op 2 4K step memory_analysis: "
        f"{compiled.memory_analysis()}")


def phase_compute_flow(card: str):
    import jax
    from flowonthego import checks
    from flowonthego.config import operating_point
    from flowonthego.models.dis_flow import compute_flow
    from flowonthego.utils import synth
    from flowonthego.utils.metrics import average_epe

    h, w = SINTEL
    I0, I1, gt = synth.pair(h, w, seed=ARGS.seed)
    for op in (1, 2, 3, 4):
        cfg = operating_point(op, width=w)
        t0 = time.perf_counter()
        flow = np.asarray(compute_flow(I0, I1, cfg))
        t_first = time.perf_counter() - t0
        assert flow.shape == (h, w, 2) and np.isfinite(flow).all()
        epe = average_epe(flow, gt)
        a, b = jax.device_put(I0), jax.device_put(I1)
        jax.block_until_ready(compute_flow(a, b, cfg))
        t0 = time.perf_counter()
        n = 5
        for _ in range(n):
            out = compute_flow(a, b, cfg)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / n * 1e3
        log(f"[compute_flow] op {op} {w}x{h}: EPE {epe:.4f} px; first call "
            f"{t_first:.1f} s; {ms:.3f} ms/pair ({card})")
        assert epe < EPE_MAX, (op, epe)
    r = checks.flow_gpu_vs_cpu(2, h, w, seed=ARGS.seed)
    log(f"[compute_flow] op 2 gpu vs cpu: q50 {r['q50']:.2e} q95 "
        f"{r['q95']:.2e} max {r['max']:.2e} px; EPE gpu {r['epe_device']:.5f}"
        f" cpu {r['epe_cpu']:.5f}")


def _stream_frames(n, h, w, seed, dtype=np.float32):
    from flowonthego.utils import synth
    for t in range(n):
        f = np.asarray(synth.frame(t, h, w, seed))
        yield np.round(f).astype(np.uint8) if dtype == np.uint8 else f


def phase_stream(card: str):
    import jax
    from flowonthego.config import operating_point
    from flowonthego.parallel import stream_flow
    from flowonthego.utils import synth
    from flowonthego.utils.metrics import average_epe

    (h, w), n = UHD, 7
    cfg = operating_point(2, width=w)
    flows = {}
    for dtype in (np.float32, np.uint8):
        frames = list(_stream_frames(n, h, w, ARGS.seed, dtype))
        out = []
        t0 = None
        for i, f in enumerate(stream_flow(iter(frames), cfg, fetch=False)):
            jax.block_until_ready(f)
            if i == 0:
                t0 = time.perf_counter()     # after the compiling pair
            out.append(f)
        ms = (time.perf_counter() - t0) / (len(out) - 1) * 1e3
        epes = [average_epe(np.asarray(f), np.asarray(synth.flow(t, h, w,
                                                                 ARGS.seed)))
                for t, f in enumerate(out)]
        name = np.dtype(dtype).name
        log(f"[stream_flow] op 2 {w}x{h} {name}: {len(out)} pairs, EPE "
            f"{' '.join(f'{e:.4f}' for e in epes)} px; {ms:.3f} ms/frame "
            f"incl. upload ({card})")
        assert all(np.isfinite(e) and e < EPE_MAX_4K for e in epes), epes
        flows[name] = np.stack([np.asarray(f) for f in out])
    # uint8 frames are the float frames rounded: the same video up to
    # quantization, so the flows agree to the flip-tolerant bound
    d = np.abs(flows["uint8"] - flows["float32"])
    log(f"[stream_flow] uint8 vs float32 ingest: mean |d| {d.mean():.2e} px")
    assert d.mean() < 0.05, d.mean()


def _multistream_vs_sequential(devices, n_streams, h, w, n_frames, tag,
                               card):
    import jax
    from flowonthego import checks
    from flowonthego.config import operating_point
    from flowonthego.parallel import stream_flow
    from flowonthego.parallel.mesh import make_mesh
    from flowonthego.parallel.multistream import MultiStream

    cfg = operating_point(2, width=w)
    seqs = np.stack([np.stack(list(_stream_frames(n_frames, h, w,
                                                  ARGS.seed + 1 + s)))
                     for s in range(n_streams)])
    mesh = make_mesh(n_data=len(devices), n_space=1, devices=devices)
    ms = MultiStream(mesh, cfg, h, w, n_streams=n_streams)
    ms.start(seqs[:, 0])
    got = [ms.push(seqs[:, t]) for t in range(1, n_frames)]
    jax.block_until_ready(got)
    shard_devs = {d for x in jax.tree.leaves(ms._state)
                  for d in x.sharding.device_set}
    assert shard_devs == set(devices), (shard_devs, devices)
    t0 = time.perf_counter()
    for t in range(1, n_frames):
        out = ms.push(seqs[:, t])
    jax.block_until_ready(out)
    ms_tick = (time.perf_counter() - t0) / (n_frames - 1) * 1e3
    worst = {"q50": 0.0, "q95": 0.0, "max": 0.0}
    with jax.default_device(devices[0]):
        for s in range(n_streams):
            for t, want in enumerate(stream_flow(iter(seqs[s]), cfg)):
                q = checks.assert_flow_close(np.asarray(got[t][s]), want,
                                             f"{tag} stream {s} pair {t}")
                worst = {k: max(worst[k], q[k]) for k in worst}
    log(f"[{tag}] {n_streams} streams {w}x{h} on {len(devices)} device(s): "
        f"worst vs sequential q50 {worst['q50']:.2e} q95 {worst['q95']:.2e} "
        f"max {worst['max']:.2e} px; {ms_tick:.3f} ms/tick ({card})")


def phase_multistream(card: str):
    import jax
    _multistream_vs_sequential(jax.devices()[:1], 4, *STREAMS, 5,
                               "multistream", card)


def phase_cli(card: str):
    from flowonthego import cli
    from flowonthego.config import operating_point
    from flowonthego.io.flo import read_flo
    from flowonthego.io.images import load_image, save_image
    from flowonthego.models.dis_flow import compute_flow
    from flowonthego.utils import synth
    from flowonthego.utils.metrics import average_epe

    h, w = SINTEL
    I0, I1, gt = synth.pair(h, w, seed=ARGS.seed)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        a, b, out = (os.path.join(tmp, n) for n in ("a.ppm", "b.ppm",
                                                     "out.flo"))
        save_image(a, I0)
        save_image(b, I1)
        assert cli.main([a, b, out, "2"]) == 0
        flow = read_flo(out)
        A, B = load_image(a), load_image(b)
    want = np.asarray(compute_flow(A, B, operating_point(2, width=w)))
    assert flow.shape == (h, w, 2)
    np.testing.assert_array_equal(flow, want)
    epe = average_epe(flow, gt)
    log(f"[cli] op 2 PPM pair -> .flo {w}x{h}: EPE {epe:.4f} px")
    assert epe < EPE_MAX, epe


def phase_four_cards(card: str):
    import jax
    import jax.numpy as jnp
    from flowonthego import checks
    from flowonthego.config import operating_point
    from flowonthego.models.dis_flow import flow_full_padded
    from flowonthego.parallel.mesh import make_mesh
    from flowonthego.parallel.spatial_fine import (make_fine_spatial_flow,
                                                   sharded_scale_levels)
    from flowonthego.utils import synth

    devs = jax.devices()[:4]
    _multistream_vs_sequential(devs, 4, *STREAMS, 5, "multistream-4", card)

    w = UHD[1]
    cfg = operating_point(2, width=w)
    # four strips of whole coarsest-scale rows: 2160 rows pad to 2560
    m = 4 << cfg.coarsest_scale
    h = -(-UHD_ROWS // m) * m
    levels = sharded_scale_levels(cfg, h, 4)
    a = np.asarray(synth.frame(0, h, w, ARGS.seed))
    b = np.asarray(synth.frame(1, h, w, ARGS.seed))
    mesh = make_mesh(n_data=1, n_space=4, devices=devs)
    fine = make_fine_spatial_flow(mesh, cfg, h, w, with_diagnostics=True)
    sharded, viol = fine(jnp.asarray(a), jnp.asarray(b))
    sharded = jax.block_until_ready(sharded)
    assert {d for d in sharded.sharding.device_set} == set(devs)
    assert int(viol) == 0, f"halo budget exceeded for {int(viol)} patches"
    t0 = time.perf_counter()
    for _ in range(5):
        out, _ = fine(jnp.asarray(a), jnp.asarray(b))
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    with jax.default_device(devs[0]):
        ref = flow_full_padded(jnp.asarray(a), jnp.asarray(b), cfg)
    q = checks.assert_flow_close(np.asarray(sharded), np.asarray(ref),
                                 "4K row strips vs unsharded")
    log(f"[spatial_fine-4] op 2 {w}x{h} row strips over 4 devices (sharded "
        f"scales {levels}): halo violations 0; vs unsharded q50 "
        f"{q['q50']:.2e} q95 {q['q95']:.2e} max {q['max']:.2e} px; "
        f"{ms:.3f} ms/pair incl. upload ({card})")


def main(argv=None) -> int:
    global ARGS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the paths spread over four cards")
    ARGS = ap.parse_args(argv)

    from flowonthego.utils.cache import enable_compile_cache
    from flowonthego.utils.logfilter import install_stderr_noise_filter
    devs, card = phase_device(4 if ARGS.four_cards else 1)
    install_stderr_noise_filter()
    enable_compile_cache()
    phases = ([phase_four_cards] if ARGS.four_cards else
              [phase_kernels, phase_compute_flow, phase_stream,
               phase_multistream, phase_cli])
    for ph in phases:
        t0 = time.perf_counter()
        ph(card)
        log(f"[{ph.__name__[6:]}] passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
