"""OpenCV DIS comparison harness.

Parity with the reference's comparison tool
(ref/flow_ref.cpp:292-357): runs
cv2.DISOpticalFlow (ULTRAFAST preset) on a frame pair, reports runtime,
and writes .flo / colorized output for side-by-side evaluation against
our engine.  Gated on the cv2 build exposing DISOpticalFlow.

    python tools/flow_ref.py img1 img2 out.flo [--viz out.png]
"""

import sys
import time

sys.path.insert(0, ".")


def main(argv):
    if len(argv) < 3:
        print(__doc__)
        return 2
    import numpy as np
    try:
        import cv2
        dis_factory = getattr(cv2, "DISOpticalFlow_create", None)
        if dis_factory is None:
            raise AttributeError
    except (ImportError, AttributeError):
        print("cv2 DISOpticalFlow unavailable in this build; "
              "comparison harness disabled")
        return 1

    from flowonthego.io.flo import write_flo
    from flowonthego.io.native import load_image_native, flow_to_color_native
    from flowonthego.io.images import save_image

    I0 = load_image_native(argv[0]).astype(np.uint8)
    I1 = load_image_native(argv[1]).astype(np.uint8)
    g0 = cv2.cvtColor(I0, cv2.COLOR_BGR2GRAY)
    g1 = cv2.cvtColor(I1, cv2.COLOR_BGR2GRAY)

    dis = dis_factory(cv2.DISOPTICAL_FLOW_PRESET_ULTRAFAST)
    t0 = time.perf_counter()
    flow = dis.calc(g0, g1, None)
    dt = (time.perf_counter() - t0) * 1e3
    print(f"cv2 DIS (ULTRAFAST): {dt:.2f} ms for {g0.shape[1]}x{g0.shape[0]}")

    write_flo(argv[2], flow)
    if "--viz" in argv:
        viz_path = argv[argv.index("--viz") + 1]
        save_image(viz_path, flow_to_color_native(flow)[..., ::-1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
