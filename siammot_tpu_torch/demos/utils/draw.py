"""The demo's two OpenCV drawing calls without ``cv2``, pixel for pixel as
``demos/utils/vis_generator.py`` makes them: ``cv2.rectangle`` at
thickness 3 and filled (-1), and ``cv2.putText`` in
``FONT_HERSHEY_SIMPLEX`` at the demo's two sizes (OpenCV 5):

  * A rectangle at thickness 3 is four thick lines (OpenCV's
    ``ThickLine``): each a band 2 pixels either side of the edge between
    its corners, and a round cap, the 13 pixels within city-block
    distance 2, at each corner; its pixels take the colour.  A filled
    rectangle covers its corners' span on both axes.
  * Text is anti-aliased: a pixel of coverage ``a`` (1-255) becomes
    ``(dst * (255 - a) + color * a + 127) // 255``.  The coverage of each
    digit and class name, with its offset from the origin, is stamped from
    ``glyphs.npz`` (written by ``tools/make_torch_glyphs.py``, which
    checks these rules against ``cv2.putText``); an id is its digits
    stamped at the font's advance (their coverages do not overlap).

Everything is clipped at the frame's edges, as OpenCV clips its polygons
line by line.  Colours are given as floats and rounded as OpenCV rounds a
``Scalar`` into uint8 (to nearest, ties to even, saturated).
"""

from __future__ import annotations

import functools
import os

import numpy as np

GLYPHS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "glyphs.npz")
HALF = 2                        # a thickness-3 line's half-width


def to_pixel(color) -> np.ndarray:
    """A colour as OpenCV stores it into a uint8 image."""
    return np.clip(np.rint(np.asarray(color, np.float64)), 0,
                   255).astype(np.uint8)


def _fill(img, x0, y0, x1, y1, color):
    """Set the pixels of [x0, x1] x [y0, y1] (inclusive) inside ``img``."""
    h, w = img.shape[:2]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def _cap(img, x, y, color):
    """The round cap of a thickness-3 line at (x, y)."""
    for dy in range(-HALF, HALF + 1):
        r = HALF - abs(dy)
        _fill(img, x - r, y + dy, x + r, y + dy, color)


def rectangle(img: np.ndarray, p1, p2, color, thickness: int) -> None:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` for thickness 3
    and -1 (filled), in place."""
    (x1, y1), (x2, y2) = (int(v) for v in p1), (int(v) for v in p2)
    c = to_pixel(color)
    lx, hx, ly, hy = min(x1, x2), max(x1, x2), min(y1, y2), max(y1, y2)
    if thickness < 0:
        _fill(img, lx, ly, hx, hy, c)
        return
    if thickness != 2 * HALF - 1:
        raise NotImplementedError(f"rectangle thickness {thickness}: the "
                                  f"demo draws 3 and -1 only")
    for y in (y1, y2):
        _fill(img, lx, y - HALF, hx, y + HALF, c)
    for x in (x1, x2):
        _fill(img, x - HALF, ly, x + HALF, hy, c)
    for x, y in ((x1, y1), (x2, y1), (x2, y2), (x1, y2)):
        _cap(img, x, y, c)


@functools.cache
def glyph_table() -> dict:
    with np.load(GLYPHS, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _stamp(img, cov, x, y, color):
    """Blend ``color`` into ``img`` at coverage ``cov`` placed at (x, y)."""
    h, w = img.shape[:2]
    ch, cw = cov.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + cw, w), min(y + ch, h)
    if x0 >= x1 or y0 >= y1:
        return
    a = cov[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.int32)[..., None]
    dst = img[y0:y1, x0:x1]
    mixed = (dst.astype(np.int32) * (255 - a) + color.astype(np.int32) * a
             + 127) // 255
    np.copyto(dst, mixed.astype(np.uint8), where=a > 0)


def put_text(img: np.ndarray, text: str, org, style: str, color) -> None:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness)`` for the strings the demo draws, in place: ``style`` "id"
    is (scale 1.5, thickness 3), digits only; "name" is (1, 2), digits
    and the class names."""
    table = glyph_table()
    c = to_pixel(color)
    x, y = int(org[0]), int(org[1])
    if f"{style}/{text}/coverage" in table:
        pieces = [(text, 0)]
    elif text.isdigit():
        adv = int(table[f"{style}/advance"])
        pieces = [(ch, i * adv) for i, ch in enumerate(text)]
    else:
        raise KeyError(f"no glyphs for {text!r} in style {style!r}")
    for piece, shift in pieces:
        dx, dy = table[f"{style}/{piece}/offset"]
        _stamp(img, table[f"{style}/{piece}/coverage"], x + shift + int(dx),
               y + int(dy), c)
