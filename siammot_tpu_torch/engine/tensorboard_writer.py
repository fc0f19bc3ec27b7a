"""TensorBoard metrics writer (port of
``siammot_tpu.engine.tensorboard_writer``), without ``tensorboard``.

Scalar losses every call (tags ``loss/total`` and ``loss/<name>``) and a
periodic image grid of the batch with its gt boxes, written as
TensorBoard's event file by this module itself: TFRecord framing (length
and data, each with a masked CRC-32C), ``Event`` and ``Summary``
protobufs encoded by hand, the grid as a PNG made with ``zlib`` and the
boxes drawn in numpy as ``cv2.rectangle(..., thickness=2)`` draws them.
:func:`read_events` reads such a file back (and checks its CRCs), so a
run's log can be checked where ``tensorboard`` is not installed.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

import numpy as np

# -- CRC-32C (Castagnoli), as TFRecord frames its records --------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)
del _i, _c


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _record(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc(length)) + data
            + struct.pack("<I", masked_crc(data)))


# -- protobuf wire format, the fields of Event and Summary used here --------

def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint(num << 3 | wire) + payload


def _bytes_field(num: int, data: bytes) -> bytes:
    return _field(num, 2, _varint(len(data)) + data)


def _event(wall_time: float, step: int = 0, file_version: str = None,
           summary: bytes = None) -> bytes:
    """Event: wall_time (1, double), step (2, int64), file_version (3),
    summary (5)."""
    out = _field(1, 1, struct.pack("<d", wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    """Summary.Value: tag (1), simple_value (2, float)."""
    return _bytes_field(1, tag.encode()) + _field(2, 5,
                                                  struct.pack("<f", value))


def _image_value(tag: str, h: int, w: int, png: bytes) -> bytes:
    """Summary.Value: tag (1), image (4): height (1), width (2),
    colorspace (3), encoded_image_string (4)."""
    image = (_field(1, 0, _varint(h)) + _field(2, 0, _varint(w))
             + _field(3, 0, _varint(3)) + _bytes_field(4, png))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, image)


def _parse(data: bytes) -> list:
    """(field, wire type, value) of one message's fields."""
    out, i = [], 0
    while i < len(data):
        key, i = _read_varint(data, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(data, i)
        elif wire == 1:
            val, i = data[i:i + 8], i + 8
        elif wire == 5:
            val, i = data[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(data, i)
            val, i = data[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire} not read here")
        out.append((num, wire, val))
    return out


def _read_varint(data: bytes, i: int):
    v = shift = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def read_events(path: str) -> list:
    """The events of one event file, each ``{"wall_time", "step",
    "file_version", "scalars": {tag: value}, "images": {tag: (h, w,
    png bytes)}}``; raises on a bad CRC or a cut record."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: cut record at byte {i}")
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        body = data[i + 12:i + 12 + n]
        (body_crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc(head) or body_crc != masked_crc(body) \
                or len(body) != n:
            raise ValueError(f"{path}: bad record at byte {i}")
        i += 16 + n
        ev = {"wall_time": 0.0, "step": 0, "file_version": None,
              "scalars": {}, "images": {}}
        for num, _, val in _parse(body):
            if num == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
            elif num == 2:
                ev["step"] = val
            elif num == 3:
                ev["file_version"] = val.decode()
            elif num == 5:
                for _, _, value in _parse(val):
                    fields = {k: v for k, _, v in _parse(value)}
                    tag = fields[1].decode()
                    if 2 in fields:
                        ev["scalars"][tag] = struct.unpack("<f",
                                                           fields[2])[0]
                    if 4 in fields:
                        img = {k: v for k, _, v in _parse(fields[4])}
                        ev["images"][tag] = (img[1], img[2], img[4])
        events.append(ev)
    return events


# -- the image grid ----------------------------------------------------------

def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [h, w, 3] -> PNG bytes (8-bit RGB, no filtering)."""
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb).reshape(h, w * 3)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def draw_box(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
             color) -> None:
    """``cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)`` in place: each
    edge a band three pixels wide centred on it, end to end."""
    h, w = img.shape[:2]
    xa, xb = min(x1, x2), max(x1, x2)
    ya, yb = min(y1, y2), max(y1, y2)

    def band(r0, r1, c0, c1):
        r0, r1 = max(r0, 0), min(r1, h - 1)
        c0, c1 = max(c0, 0), min(c1, w - 1)
        if r0 <= r1 and c0 <= c1:
            img[r0:r1 + 1, c0:c1 + 1] = color

    for y in (ya, yb):
        band(y - 1, y + 1, xa, xb)
    for x in (xa, xb):
        band(ya, yb, x - 1, x + 1)


class TensorboardWriter:
    """Scalars of every call and, every ``image_period`` iterations when a
    batch is given, its first images with their gt boxes, into one event
    file under ``output_dir``."""

    def __init__(self, cfg, output_dir: str, image_period: int = 500):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(
            output_dir, f"events.out.tfevents.{int(time.time()):010d}."
                        f"{socket.gethostname()}.{os.getpid()}")
        self._f = open(self.path, "ab")
        self._mean = np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32)
        self._std = np.asarray(cfg.INPUT.PIXEL_STD, np.float32)
        self._image_period = image_period
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(_record(event))
        self._f.flush()

    def __call__(self, iteration: int, metrics: dict, images=None, gt=None):
        for k, v in metrics.items():
            tag = "loss/total" if k == "loss" else f"loss/{k}"
            self._write(_event(time.time(), iteration,
                               summary=_bytes_field(
                                   1, _scalar_value(tag, float(v)))))
        if images is not None and iteration % self._image_period == 0:
            self.write_image(iteration, images, gt)

    def write_image(self, iteration: int, images, gt=None,
                    max_images: int = 4):
        """The first ``max_images`` frames side by side (de-normalised
        when they are float), gt boxes drawn in green."""
        imgs = np.asarray(images)[:max_images]
        out = []
        for i, im in enumerate(imgs):
            if im.dtype == np.uint8:     # raw frames (device-normalize mode)
                x = im.copy()
            else:
                x = np.clip((im * self._std + self._mean) * 255.0, 0,
                            255).astype(np.uint8).copy()
            if gt is not None:
                boxes = np.asarray(gt.boxes[i])
                valid = np.asarray(gt.valid[i])
                for b, v in zip(boxes, valid):
                    if v:
                        draw_box(x, int(b[0]), int(b[1]), int(b[2]),
                                 int(b[3]), (0, 255, 0))
            out.append(x)
        grid = np.concatenate(out, axis=1)
        self._write(_event(time.time(), iteration, summary=_bytes_field(
            1, _image_value("train/gt", grid.shape[0], grid.shape[1],
                            encode_png(grid)))))

    def close(self):
        self._f.close()
