"""color_flow: render a .flo file to a color-wheel PNG.

CLI parity with the reference's evaluation tool
(flow_code/C/color_flow.cpp:17-60 and tools/color_flow):

    python tools/color_flow.py in.flo out.png [max_motion]
"""

import sys

sys.path.insert(0, ".")


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 2
    from flowonthego.io.flo import read_flo
    from flowonthego.io.native import flow_to_color_native
    from flowonthego.io.images import save_image

    flow = read_flo(argv[0])
    max_motion = float(argv[2]) if len(argv) > 2 else 0.0
    rgb = flow_to_color_native(flow, max_motion)
    save_image(argv[1], rgb[..., ::-1])  # save_image expects BGR
    print(f"{argv[0]} ({flow.shape[1]}x{flow.shape[0]}) -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
