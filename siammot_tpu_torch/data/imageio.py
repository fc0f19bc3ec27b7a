"""Still images for the port: its counterpart of ``cv2.imread(path,
cv2.IMREAD_COLOR)`` followed by ``cv2.COLOR_BGR2RGB``, without ``cv2``.

:func:`imread` returns uint8 [h, w, 3] RGB.  The decoder is chosen by the
file's first bytes, as OpenCV chooses it, not by its name:

  * JPEG: ``data/native.py`` on the caller's route (libjpeg on the CPU,
    whose bytes are ``cv2.imread``'s; nvJPEG on the card);
  * PNG: ``data/png.py`` (``zlib`` and a C++ unfilter);
  * BMP: ``data/bmp.py`` (numpy).

Any other format raises ``NotImplementedError`` naming it.

The EXIF Orientation tag (a JPEG's APP1 ``Exif`` segment, a PNG's eXIf
chunk) is applied as OpenCV applies it, so a rotated image reports and
returns its rotated size.  The dataset-inference route over JPEG folders
(``video_loader.normalized_frame_source``) reads its files raw, as the
JAX package's native reader does, and does not come through here.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bmp, native, png

# magic bytes of formats the port does not read, for the error
OTHER_FORMATS = ((b"GIF8", "GIF"), (b"RIFF", "WebP or another RIFF file"),
                 (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                 (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
                 (b"\xff\x4f\xff\x51", "JPEG 2000 codestream"),
                 (b"P1", "PBM"), (b"P2", "PGM"), (b"P3", "PPM"),
                 (b"P4", "PBM"), (b"P5", "PGM"), (b"P6", "PPM"),
                 (b"#?RADIANCE", "Radiance HDR"), (b"\x76\x2f\x31\x01",
                                                   "OpenEXR"))
ORIENTATION_TAG = 0x0112


def sniff(data: bytes) -> str:
    """'jpeg', 'png' or 'bmp' from the first bytes; raises
    ``NotImplementedError`` for anything else."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == png.SIGNATURE:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    for magic, name in OTHER_FORMATS:
        if data.startswith(magic):
            raise NotImplementedError(
                f"{name} images: the port reads JPEG, PNG and BMP only")
    raise NotImplementedError(f"an image format the port does not know "
                              f"(first bytes {data[:8].hex()}); it reads "
                              f"JPEG, PNG and BMP")


# -- EXIF --------------------------------------------------------------------

def jpeg_exif(data: bytes):
    """The TIFF stream of a JPEG's first APP1 ``Exif`` segment, or None.
    Only the markers before the first scan are read."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:                  # fill byte
            pos += 1
            continue
        if marker in (0xD9, 0xDA):          # end of image, start of scan
            return None
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 2
            continue
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body[6:]
        pos += 2 + length
    return None


def orientation(tiff) -> int:
    """The Orientation tag of IFD0 in a TIFF stream (little- or
    big-endian), or 1 where it is absent or the stream is malformed."""
    if tiff is None or len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(e + "H", tiff[2:4])[0] != 42:
        return 1
    ifd, = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    n, = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, kind, count = struct.unpack(e + "HHI", tiff[at:at + 8])
        if tag == ORIENTATION_TAG and kind == 3 and count >= 1:
            return struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
    return 1


def apply_orientation(img: np.ndarray, tag: int) -> np.ndarray:
    """OpenCV's ``ExifTransform`` for tags 2-8 (others leave the image):
    the flips and transposes that bring the image upright."""
    if tag in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
        tag = {5: 1, 6: 2, 7: 3, 8: 4}[tag]
    if tag == 2:
        img = img[:, ::-1]
    elif tag == 3:
        img = img[::-1, ::-1]
    elif tag == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _orientation_of(kind: str, data: bytes) -> int:
    if kind == "jpeg":
        return orientation(jpeg_exif(data))
    if kind == "png":
        return orientation(png.exif(data))
    return 1


# -- the reader --------------------------------------------------------------

def decode(data: bytes, device="cpu", what="(an image in memory)"
           ) -> np.ndarray:
    """An image file's bytes -> uint8 [h, w, 3] RGB, upright."""
    kind = sniff(data)
    if kind == "jpeg":
        img = native.decode_jpeg_bytes(data, device, what)
    elif kind == "png":
        img = png.decode(data, what)
    else:
        img = bmp.decode(data, what)
    return apply_orientation(img, _orientation_of(kind, data))


def imread(path: str, device="cpu") -> np.ndarray:
    """One still as uint8 [h, w, 3] RGB, upright (JPEG on ``device``'s
    route)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        raise IOError(f"{path}: an empty file")
    return decode(data, device, path)


def image_size(path: str) -> tuple:
    """(w, h) of a still as :func:`imread` returns it (rotated by its EXIF
    orientation), from its headers."""
    with open(path, "rb") as f:
        data = f.read()
    kind = sniff(data)
    if kind == "jpeg":
        w, h = native.image_size(path)
    elif kind == "png":
        w, h = png.image_size(data, path)
    else:
        w, h = bmp.image_size(data, path)
    if _orientation_of(kind, data) in (5, 6, 7, 8):
        w, h = h, w
    return w, h
