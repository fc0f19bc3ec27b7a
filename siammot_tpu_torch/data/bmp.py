"""BMP stills for the port, without ``cv2`` or ``PIL``: the bytes of
``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV's own BMP decoder), as RGB.

Uncompressed (``BI_RGB``) images at 24 and 32 bits a pixel (the fourth
byte dropped) and palette images at 1, 4 and 8 bits, bottom-up (a
positive height) or top-down (a negative one), with the Windows
(BITMAPINFOHEADER and later) and OS/2 (BITMAPCOREHEADER) headers.  Rows
are padded to 4 bytes.  Any other compression (RLE, bit fields, embedded
JPEG or PNG) or bit count raises ``NotImplementedError`` naming the header
field.
"""

from __future__ import annotations

import struct

import numpy as np

COMPRESSION = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS",
               4: "BI_JPEG", 5: "BI_PNG", 6: "BI_ALPHABITFIELDS"}


def header(data: bytes, what) -> dict:
    """The fields of the file and DIB headers the decoder reads."""
    if data[:2] != b"BM" or len(data) < 26:
        raise IOError(f"{what}: not a BMP file")
    offset, = struct.unpack("<I", data[10:14])
    size, = struct.unpack("<I", data[14:18])
    if size == 12:                                  # BITMAPCOREHEADER
        w, h, planes, bpp = struct.unpack("<hhHH", data[18:26])
        comp, used, entry = 0, 0, 3
    elif size >= 40 and len(data) >= 14 + 40:
        w, h, planes, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        used, = struct.unpack("<I", data[46:50])
        entry = 4
    else:
        raise IOError(f"{what}: a BMP header of {size} bytes")
    return dict(offset=offset, size=size, width=w, height=h, bpp=bpp,
                compression=comp, colors_used=used, entry=entry)


def image_size(data: bytes, what="(a BMP in memory)") -> tuple:
    hd = header(data, what)
    return hd["width"], abs(hd["height"])


def decode(data: bytes, what="(a BMP in memory)") -> np.ndarray:
    """A BMP file's bytes -> uint8 [h, w, 3] RGB."""
    hd = header(data, what)
    w, h, bpp, comp = hd["width"], hd["height"], hd["bpp"], hd["compression"]
    if comp != 0:
        raise NotImplementedError(
            f"{what}: BMP compression (biCompression) "
            f"{COMPRESSION.get(comp, comp)}: the port reads BI_RGB only")
    if bpp not in (1, 4, 8, 24, 32):
        raise NotImplementedError(f"{what}: BMP bit count (biBitCount) {bpp}"
                                  f": the port reads 1, 4, 8, 24 and 32")
    if w <= 0 or h == 0:
        raise IOError(f"{what}: BMP size {w}x{h}")
    rows, top_down = abs(h), h < 0
    stride = (w * bpp + 31) // 32 * 4
    end = hd["offset"] + stride * rows
    if end > len(data):
        raise IOError(f"{what}: the pixel array ends past the file")
    px = np.frombuffer(data, np.uint8, stride * rows,
                       hd["offset"]).reshape(rows, stride)
    if not top_down:
        px = px[::-1]
    if bpp >= 24:
        bgr = px[:, :w * bpp // 8].reshape(rows, w, bpp // 8)[..., :3]
        return np.ascontiguousarray(bgr[..., ::-1])
    n = hd["colors_used"] or 1 << bpp
    start = 14 + hd["size"]
    entries = np.frombuffer(data, np.uint8, min(n, 256) * hd["entry"],
                            start).reshape(-1, hd["entry"])
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(entries)] = entries[:, 2::-1]      # BGR(x) -> RGB
    if bpp == 8:
        idx = px[:, :w]
    else:
        bits = np.unpackbits(px, axis=1).reshape(rows, -1, bpp)
        weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
        idx = (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w]
    return palette[idx]
