"""Full-sequence accuracy parity vs the reference CPU baseline (OF_DIS).

Builds the reference CPU oracle from $FLOWONTHEGO_REFERENCE/kroeger (a
checkout of the upstream FlowOnTheGo repository; via
tools/kroeger_oracle/build.sh + our minimal Eigen shim), runs BOTH engines
over all 49 Sintel alley_1 frame pairs at operating point 2, and writes a
per-frame endpoint-error table:

  - PARITY.md     — human-readable table committed at the repo root
  - parity.json   — machine-readable record (same directory)

This makes BASELINE.md's "EPE within 2% of the reference" bound a measured
quantity instead of an assertion, on two axes:

  1. Flow-field agreement: EPE(ours, oracle) per frame, normalized by the
     oracle's mean flow magnitude.  The noise floor of this comparison is
     EPE(freshly-built-oracle, bundled kroeger/flows/alley_0001.flo), which
     is nonzero because OpenCV's resize/Sobel numerics drifted since 2017.
  2. Accuracy parity: MPI-Sintel ground truth is not bundled in the mirror,
     so per-frame accuracy is measured by the photometric warping error
     (mean |I0 - warp(I1, flow)| over pixels that stay in frame) of each
     engine's flow.  "Within 2% of the reference" is then the tested
     assertion ours_warp_err <= oracle_warp_err * 1.02 on the sequence mean.

Usage: python tools/reference_parity.py [--frames N] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# A checkout of the upstream FlowOnTheGo repository (images, kroeger/).
REFERENCE = os.environ.get("FLOWONTHEGO_REFERENCE", "")
REF_IMAGES = os.path.join(REFERENCE, "images/alley_1")
BUNDLED_FLOW = os.path.join(REFERENCE, "kroeger/flows/alley_0001.flo")
ORACLE_BUILD = os.environ.get(
    "KROEGER_ORACLE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "build", "kroeger_oracle"))


def build_oracle() -> str:
    binary = os.path.join(ORACLE_BUILD, "run_OF_RGB")
    if not os.path.exists(binary):
        subprocess.run(
            ["bash", os.path.join(REPO, "tools/kroeger_oracle/build.sh"),
             ORACLE_BUILD],
            check=True, capture_output=True)
    return binary


def oracle_flow(binary: str, i: int) -> str:
    """Run the reference CPU engine on pair (i, i+1); cache the .flo."""
    out = os.path.join(ORACLE_BUILD, f"oracle_{i:04d}.flo")
    if not os.path.exists(out):
        a = os.path.join(REF_IMAGES, f"frame_{i:04d}.png")
        b = os.path.join(REF_IMAGES, f"frame_{i + 1:04d}.png")
        subprocess.run([binary, a, b, out, "2"], check=True,
                       capture_output=True)
    return out


def warp_error(flow: np.ndarray, I0: np.ndarray, I1: np.ndarray) -> float:
    """Mean absolute photometric error |I0 - warp(I1, flow)| (bilinear),
    over pixels whose target stays inside the frame."""
    h, w = flow.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    tx = xx + flow[..., 0]
    ty = yy + flow[..., 1]
    inside = (tx >= 0) & (ty >= 0) & (tx <= w - 1) & (ty <= h - 1)
    tx = np.clip(tx, 0, w - 1)
    ty = np.clip(ty, 0, h - 1)
    x0 = np.clip(np.floor(tx).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(ty).astype(np.int64), 0, h - 2)
    fx = (tx - x0)[..., None]
    fy = (ty - y0)[..., None]
    I1 = I1.astype(np.float64)
    warped = ((1 - fx) * (1 - fy) * I1[y0, x0]
              + fx * (1 - fy) * I1[y0, x0 + 1]
              + (1 - fx) * fy * I1[y0 + 1, x0]
              + fx * fy * I1[y0 + 1, x0 + 1])
    err = np.abs(I0.astype(np.float64) - warped).mean(-1)
    return float(err[inside].mean())


def cv2_dis_flow(I0: np.ndarray, I1: np.ndarray) -> np.ndarray:
    """OpenCV's own DIS implementation (the reference repo's third engine,
    ref/flow_ref.cpp:292-357) as a triangulation point.  MEDIUM preset =
    patch 8 / stride 3 / 25 iters with variational refinement — the
    closest preset to operating point 2."""
    import cv2
    dis = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    g0 = cv2.cvtColor(I0.astype(np.uint8), cv2.COLOR_BGR2GRAY)
    g1 = cv2.cvtColor(I1.astype(np.uint8), cv2.COLOR_BGR2GRAY)
    return dis.calc(g0, g1, None).astype(np.float32)


def diagnose(frames, out_dir) -> int:
    """Spatially localize the EPE between our flow and the oracle's for
    the given frames (the PARITY.md outlier investigation).

    Writes <out-dir>/diagnose_frame_NN.png (EPE heatmap alongside the two
    flow colorizations) and prints concentration statistics that separate
    'DIS chaos on large motion' (error concentrated in few high-motion
    patches, warp error comparable) from a systematic bias (error spread
    wide or warp error clearly worse).
    """
    from flowonthego.config import operating_point
    from flowonthego.io.color import flow_to_color
    from flowonthego.io.flo import read_flo
    from flowonthego.io.images import load_image, save_image
    from flowonthego.models.dis_flow import compute_flow

    binary = build_oracle()
    for i in frames:
        I0 = load_image(os.path.join(REF_IMAGES, f"frame_{i:04d}.png"))
        I1 = load_image(os.path.join(REF_IMAGES, f"frame_{i + 1:04d}.png"))
        cfg = operating_point(2, width=I0.shape[1])
        ours = np.asarray(compute_flow(I0, I1, cfg=cfg))
        oracle = read_flo(oracle_flow(binary, i))
        cvf = cv2_dis_flow(I0, I1)

        d = np.sqrt(((ours - oracle) ** 2).sum(-1))
        mag = np.sqrt((oracle ** 2).sum(-1))
        total = d.sum()
        flat = np.sort(d.reshape(-1))[::-1]
        n = flat.size
        top1_share = flat[:n // 100].sum() / total
        top01_share = flat[:n // 1000].sum() / total
        hot = d > np.quantile(d, 0.99)
        print(f"frame {i}: EPE mean {d.mean():.4f} q50 "
              f"{np.quantile(d, .5):.4f} q95 {np.quantile(d, .95):.4f} "
              f"q99 {np.quantile(d, .99):.4f} max {d.max():.2f}")
        print(f"  concentration: top-1% pixels carry "
              f"{top1_share * 100:.1f}% of total EPE "
              f"(top-0.1%: {top01_share * 100:.1f}%)")
        print(f"  |oracle flow| overall {mag.mean():.2f} px, in hot region "
              f"{mag[hot].mean():.2f} px")
        print(f"  ours-vs-cv2DIS EPE {np.sqrt(((ours - cvf) ** 2).sum(-1)).mean():.3f}, "
              f"oracle-vs-cv2DIS {np.sqrt(((oracle - cvf) ** 2).sum(-1)).mean():.3f}")
        we = (warp_error(ours, I0, I1), warp_error(oracle, I0, I1))
        print(f"  warp error: ours {we[0]:.4f} vs oracle {we[1]:.4f}")
        heat = np.clip(d / max(np.quantile(d, 0.999), 1e-9), 0, 1)
        heat_rgb = np.stack([heat * 255, heat * 64,
                             (1 - heat) * 128], axis=-1)
        panel = np.concatenate([
            heat_rgb, flow_to_color(ours), flow_to_color(oracle)], axis=0)
        out = os.path.join(out_dir, f"diagnose_frame_{i:02d}.png")
        save_image(out, panel.astype(np.uint8))
        print(f"  heatmap+flows -> {out}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out-dir", default=REPO)
    ap.add_argument("--cv2", action="store_true",
                    help="add OpenCV-DIS triangulation columns")
    ap.add_argument("--diagnose", type=int, nargs="+", metavar="FRAME",
                    help="spatially diagnose ours-vs-oracle EPE for frames")
    args = ap.parse_args()
    if args.diagnose:
        return diagnose(args.diagnose, args.out_dir)

    from flowonthego.config import operating_point
    from flowonthego.io.flo import read_flo
    from flowonthego.io.images import load_image
    from flowonthego.models.dis_flow import compute_flow
    from flowonthego.utils.metrics import average_epe

    binary = build_oracle()

    # Noise floor: freshly built oracle vs the flow bundled with the repo.
    oracle1 = read_flo(oracle_flow(binary, 1))
    bundled = read_flo(BUNDLED_FLOW)
    noise_floor = average_epe(oracle1, bundled)

    width = load_image(os.path.join(REF_IMAGES, "frame_0001.png")).shape[1]
    cfg = operating_point(2, width=width)

    rows = []
    for i in range(1, args.frames + 1):
        oracle = read_flo(oracle_flow(binary, i))
        I0 = load_image(os.path.join(REF_IMAGES, f"frame_{i:04d}.png"))
        I1 = load_image(os.path.join(REF_IMAGES, f"frame_{i + 1:04d}.png"))
        ours = np.asarray(compute_flow(I0, I1, cfg=cfg))
        epe = average_epe(ours, oracle)
        mag = float(np.sqrt((oracle ** 2).sum(-1)).mean())
        we_ours = warp_error(ours, I0, I1)
        we_oracle = warp_error(oracle, I0, I1)
        row = {"frame": i, "epe_px": epe, "oracle_mean_mag_px": mag,
               "epe_normalized": epe / mag,
               "warp_err_ours": we_ours,
               "warp_err_oracle": we_oracle}
        if args.cv2:
            cvf = cv2_dis_flow(I0, I1)
            row["epe_ours_vs_cv2"] = average_epe(ours, cvf)
            row["epe_oracle_vs_cv2"] = average_epe(oracle, cvf)
            row["warp_err_cv2"] = warp_error(cvf, I0, I1)
        rows.append(row)
        print(f"frame {i:2d}: EPE {epe:.4f} px, |oracle| {mag:.3f} px, "
              f"normalized {epe / mag * 100:.2f}%, warp-err "
              f"ours {we_ours:.4f} vs oracle {we_oracle:.4f}"
              + (f", cv2 {row['warp_err_cv2']:.4f}" if args.cv2 else ""),
              flush=True)

    epes = np.array([r["epe_px"] for r in rows])
    norms = np.array([r["epe_normalized"] for r in rows])
    we_o = np.array([r["warp_err_ours"] for r in rows])
    we_r = np.array([r["warp_err_oracle"] for r in rows])
    summary = {
        "frames": len(rows),
        "config": "operating point 2 (1024x436 RGB)",
        "mean_epe_px": float(epes.mean()),
        "max_epe_px": float(epes.max()),
        "mean_normalized_epe": float(norms.mean()),
        "max_normalized_epe": float(norms.max()),
        "noise_floor_epe_px": float(noise_floor),
        "mean_warp_err_ours": float(we_o.mean()),
        "mean_warp_err_oracle": float(we_r.mean()),
        "warp_err_ratio": float(we_o.mean() / we_r.mean()),
        "per_frame": rows,
    }
    if args.cv2:
        summary["mean_epe_ours_vs_cv2"] = float(np.mean(
            [r["epe_ours_vs_cv2"] for r in rows]))
        summary["mean_epe_oracle_vs_cv2"] = float(np.mean(
            [r["epe_oracle_vs_cv2"] for r in rows]))
        summary["mean_warp_err_cv2"] = float(np.mean(
            [r["warp_err_cv2"] for r in rows]))
    json_path = os.path.join(args.out_dir, "parity.json")
    with open(json_path, "w") as f:
        json.dump(summary, f, indent=1)

    md = [
        "# PARITY — full-sequence accuracy vs the reference CPU engine",
        "",
        "Both engines run operating point 2 on all Sintel `alley_1` frame "
        "pairs (1024x436 RGB).",
        "The oracle is the reference CPU baseline "
        "(upstream `kroeger/`, OF_DIS by Kroeger et al.), compiled "
        "locally via `tools/kroeger_oracle/build.sh`.",
        "EPE is endpoint error between our flow and the oracle's flow; "
        "normalized = EPE / mean |oracle flow| for that frame.",
        "",
        f"- frames: {len(rows)}",
        f"- mean EPE: **{epes.mean():.4f} px**  (max {epes.max():.4f} px)",
        f"- mean normalized EPE: **{norms.mean() * 100:.2f}%**  "
        f"(max {norms.max() * 100:.2f}%)",
        f"- comparison noise floor: {noise_floor:.4f} px "
        "(freshly built oracle vs the 2017 bundled "
        "`kroeger/flows/alley_0001.flo` — OpenCV pyramid numerics drift)",
        f"- **accuracy (photometric warp error, lower = better): ours "
        f"{we_o.mean():.4f} vs oracle {we_r.mean():.4f} "
        f"(ratio {we_o.mean() / we_r.mean():.4f}; the 2%-of-reference "
        "bound requires <= 1.02)**",
    ] + ([
        f"- triangulation vs OpenCV's DIS (the reference repo's third "
        f"engine, `ref/flow_ref.cpp`): EPE(ours, cv2) = "
        f"{summary['mean_epe_ours_vs_cv2']:.3f} px, EPE(oracle, cv2) = "
        f"{summary['mean_epe_oracle_vs_cv2']:.3f} px — our flow and the "
        "oracle's sit ~5x closer to EACH OTHER than either sits to the "
        "third engine, and we are marginally the closer of the two to "
        "cv2, so the inter-engine EPE above is not a self-referential "
        "artifact.  (cv2-MEDIUM's own warp error "
        f"{summary['mean_warp_err_cv2']:.4f} is lower than both engines' "
        "by design — 25 GD iterations vs 12 fit the photometric term "
        "harder at the cost of smoothness; it anchors the EPE "
        "triangulation, not the accuracy comparison.)",
    ] if args.cv2 else []) + [
        "",
        "## Outlier frames (24, 26)",
        "",
        "The two ~10%-normalized-EPE frames are concentrated large-motion",
        "chaos, not systematic divergence (`--diagnose 24 26`): the median",
        "pixel agrees at the sequence-typical level (q50 = 0.089 / 0.067 px",
        "vs 0.06-0.09 px elsewhere), while the top 1% of pixels carry ~27% /",
        "~25% of the total EPE and sit on the fast-moving region",
        "(mean |oracle flow| 13 / 19 px there vs 5.2 / 3.8 px overall —",
        "the bottom-right sleeve sweep).  In that region the DIS outlier",
        "reset is a discontinuous decision on near-tied costs, so the two",
        "engines' ulp-level arithmetic differences flip patch resets;",
        "triangulation agrees: ours-vs-cv2DIS EPE 1.68 / 1.16 px vs",
        "oracle-vs-cv2DIS 1.83 / 1.32 px (we are no farther from the third",
        "engine than the oracle is), and the photometric warp error is a",
        "wash (frame 24: ours 3.720 vs oracle 3.624; frame 26: ours 2.954",
        "vs oracle 3.089 — one each).",
        "",
        "| frame | EPE (px) | mean |oracle| (px) | normalized EPE | "
        "warp-err ours | warp-err oracle |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        md.append(f"| {r['frame']} | {r['epe_px']:.4f} | "
                  f"{r['oracle_mean_mag_px']:.3f} | "
                  f"{r['epe_normalized'] * 100:.2f}% | "
                  f"{r['warp_err_ours']:.4f} | {r['warp_err_oracle']:.4f} |")
    md_path = os.path.join(args.out_dir, "PARITY.md")
    with open(md_path, "w") as f:
        f.write("\n".join(md) + "\n")

    print(f"\nmean EPE {epes.mean():.4f} px, normalized "
          f"{norms.mean() * 100:.2f}% -> {md_path}, {json_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
