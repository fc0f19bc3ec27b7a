"""PNG stills for the port, without ``cv2`` or ``PIL``: the bytes of
``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV over libpng), as RGB.

The chunks are read here, the IDAT stream is inflated with the standard
library's ``zlib``, and the scanline filters are undone in C++
(``png.cpp``, built at first use by ``data/native.py``), per image or per
Adam7 pass.  Every colour type (grey, RGB, palette, grey + alpha, RGBA) and
bit depth (1, 2, 4, 8, 16) reduces to three 8-bit channels as OpenCV asks
libpng to: alpha dropped, grey replicated, a palette expanded, grey below
8 bits scaled to 0-255 by replicating its bits, 16 bits cut to their high
byte (``png_set_strip_16``).  The CRC of each chunk is checked, as libpng
checks it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel by colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunks(data: bytes, what):
    """Yield (type, body) of each chunk, CRC checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise IOError(f"{what}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            break
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise IOError(f"{what}: CRC error in the {kind.decode('latin-1')}"
                          f" chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise IOError(f"{what}: the file ends before IEND")


def header(data: bytes, what) -> tuple:
    """(width, height, bit depth, colour type, interlace) from IHDR."""
    kind, body = next(chunks(data, what))
    if kind != b"IHDR" or len(body) != 13:
        raise IOError(f"{what}: the first chunk is not IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if ctype not in CHANNELS or depth not in DEPTHS[ctype]:
        raise IOError(f"{what}: colour type {ctype} at bit depth {depth} is "
                      f"not a PNG format")
    if comp != 0 or filt != 0 or interlace not in (0, 1) or not w or not h:
        raise IOError(f"{what}: IHDR compression {comp}, filter {filt}, "
                      f"interlace {interlace}, size {w}x{h}: not a PNG "
                      f"image")
    return w, h, depth, ctype, interlace


def _unfilter(raw: bytes, rows: int, row_bytes: int, bpp: int, what):
    out = np.empty((rows, row_bytes), np.uint8)
    rc = native.png_library().png_unfilter(
        raw, rows, row_bytes, bpp,
        out.ctypes.data_as(native._u8p))
    if rc:
        raise IOError(f"{what}: row {rc - 1} has an unknown filter type")
    return out


def _samples(rows: np.ndarray, width: int, depth: int, n: int) -> np.ndarray:
    """Unfiltered rows -> [rows, width, n] samples (uint8 or uint16)."""
    if depth == 16:
        return rows.view(">u2").reshape(len(rows), -1)[:, :width * n] \
            .astype(np.uint16).reshape(len(rows), width, n)
    if depth == 8:
        return rows[:, :width * n].reshape(len(rows), width, n)
    bits = np.unpackbits(rows, axis=1).reshape(len(rows), -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(axis=2, dtype=np.uint8)
    return vals[:, :width * n].reshape(len(rows), width, n)


def decode(data: bytes, what="(a PNG in memory)") -> np.ndarray:
    """A PNG file's bytes -> uint8 [h, w, 3] RGB, as ``cv2.imread`` with
    ``IMREAD_COLOR`` reads it (then BGR to RGB)."""
    w, h, depth, ctype, interlace = header(data, what)
    palette, idat = None, []
    for kind, body in chunks(data, what):
        if kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ctype == 3 and palette is None:
        raise IOError(f"{what}: a palette image without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"{what}: the image data does not inflate: {e}") \
            from None
    n = CHANNELS[ctype]
    bpp = max(1, n * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((h, w, n), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        row_bytes = -(-pw * n * depth // 8)
        size = ph * (row_bytes + 1)
        if pos + size > len(raw):
            raise IOError(f"{what}: the image data ends early")
        rows = _unfilter(raw[pos:pos + size], ph, row_bytes, bpp, what)
        samples[y0::dy, x0::dx] = _samples(rows, pw, depth, n)
        pos += size
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    elif depth < 8 and ctype == 0:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[samples[..., 0]]
    if ctype in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def image_size(data: bytes, what="(a PNG in memory)") -> tuple:
    """(w, h) of a PNG from IHDR."""
    return header(data, what)[:2]


def exif(data: bytes, what="(a PNG in memory)"):
    """The body of the eXIf chunk (a TIFF stream), or None."""
    for kind, body in chunks(data, what):
        if kind == b"eXIf":
            return body
        if kind == b"IDAT":
            return None
    return None
