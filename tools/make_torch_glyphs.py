#!/usr/bin/env python3
"""Write the PyTorch port's glyph table for the demo's overlay text:
``siammot_tpu_torch/demos/utils/glyphs.npz``.

The demo writes each track's id with ``cv2.putText(frame, str(id), org,
FONT_HERSHEY_SIMPLEX, 1.5, color, thickness=3)`` and its class name with
``cv2.putText(frame, name, org, FONT_HERSHEY_SIMPLEX, 1, (0, 0, 0),
thickness=2)`` (``demos/utils/vis_generator.py``).  OpenCV 5 draws text
anti-aliased: each pixel it touches takes ``(dst * (255 - a) + color * a +
127) // 255`` for a coverage ``a`` in 1-255 (the colour rounded to uint8
first), and for an integer origin the coverage only moves with the
origin.  So the table holds, for each string the demo can draw, its
coverage (the text drawn in 255 on 0) and the map's offset from the
origin:

  * ``id``: the ten digits at (1.5, 3); an id is its digits stamped side
    by side at a fixed advance;
  * ``name``: the ten digits and the nine class names of
    ``COCO_CLASS_NAMES`` at (1, 2) (a label past the names is drawn as its
    number).

Before it writes, the tool checks what it relies on against
``cv2.putText``: the blend over every background byte (with every colour
byte where the background is a multiple of 17, else a sweep), the
maps at other origins, and digit strings against the digits stamped one
after another.  The port reads the committed file and needs no ``cv2``.

    python tools/make_torch_glyphs.py [--out PATH]
"""

import argparse
import os
import sys

import cv2
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from demos.utils.vis_generator import COCO_CLASS_NAMES  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "siammot_tpu_torch", "demos", "utils", "glyphs.npz")
STYLES = {"id": (1.5, 3), "name": (1.0, 2)}
CANVAS = (240, 900)                 # h, w
ORIGIN = (100, 150)                 # x, y


def draw(text, style, origin=ORIGIN, background=0, color=255):
    scale, thickness = STYLES[style]
    img = np.full(CANVAS, background, np.uint8)
    cv2.putText(img, text, origin, cv2.FONT_HERSHEY_SIMPLEX, scale, color,
                thickness=thickness)
    return img


def blend(dst, color, a):
    dst, a = dst.astype(np.int64), a.astype(np.int64)
    return np.where(a > 0, (dst * (255 - a) + color * a + 127) // 255, dst)


def coverage_of(text, style):
    """(coverage, (dx, dy)): the coverage, cropped, and the crop's top-left
    corner relative to the origin."""
    full = draw(text, style)
    ys, xs = np.nonzero(full)
    y0, x0 = ys.min(), xs.min()
    cov = full[y0:ys.max() + 1, x0:xs.max() + 1]
    if y0 == 0 or x0 == 0 or ys.max() == CANVAS[0] - 1 \
            or xs.max() == CANVAS[1] - 1:
        raise AssertionError(f"{text!r} reaches the canvas's edge")
    return cov, (int(x0 - ORIGIN[0]), int(y0 - ORIGIN[1]))


def stamp(canvas, cov, offset, origin, color=255):
    x, y = origin[0] + offset[0], origin[1] + offset[1]
    h, w = cov.shape
    canvas[y:y + h, x:x + w] = blend(canvas[y:y + h, x:x + w], color, cov)


def stamped(text, style, table, advance, origin=ORIGIN):
    out = np.zeros(CANVAS, np.uint8)
    for i, ch in enumerate(text):
        cov, off = table[(style, ch)]
        stamp(out, cov, off, (origin[0] + i * advance, origin[1]))
    return out


def check_blend():
    """The blend rule over every background byte, with every colour byte
    where the background is a multiple of 17 and a sweep elsewhere."""
    cov = draw("0123456789", "id")
    for bg in range(256):
        backgrounds = np.full(CANVAS, bg, np.uint8)
        for color in range(0, 256, 1 if bg % 17 == 0 else 51):
            want = draw("0123456789", "id", background=bg, color=color)
            if not (blend(backgrounds, color, cov) == want).all():
                raise AssertionError(f"the blend of {color} over {bg}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()

    check_blend()
    table, advances = {}, {}
    texts = {"id": [str(d) for d in range(10)],
             "name": [str(d) for d in range(10)] + list(COCO_CLASS_NAMES)}
    for style, strings in texts.items():
        for text in strings:
            table[(style, text)] = coverage_of(text, style)
            # the coverage moves with an integer origin
            for origin in ((101, 150), (100, 151), (137, 173), (3, 60)):
                got = np.zeros(CANVAS, np.uint8)
                stamp(got, *table[(style, text)], origin)
                if not (got == draw(text, style, origin)).all():
                    raise AssertionError(f"{text!r} ({style}) at {origin} "
                                         f"is not the coverage moved")
        # the advance that stamps every digit string cv2 draws
        probes = ["0123456789", "9876543210", "11", "707", "42", "10000",
                  "99999"]
        fits = [a for a in range(1, 80)
                if all((stamped(p, style, table, a) == draw(p, style)).all()
                       for p in probes)]
        if len(fits) != 1:
            raise AssertionError(f"{style}: digit advances that fit: {fits}")
        advances[style] = fits[0]

    arrays = {}
    for (style, text), (cov, off) in table.items():
        arrays[f"{style}/{text}/coverage"] = cov
        arrays[f"{style}/{text}/offset"] = np.array(off, np.int32)
    for style, a in advances.items():
        arrays[f"{style}/advance"] = np.array(a, np.int32)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {len(table)} coverage maps, digit advances "
          f"{advances} (cv2 {cv2.__version__})")


if __name__ == "__main__":
    main()
