"""The port's still-image readers (``siammot_tpu_torch/data/imageio.py``,
``png.py`` + ``png.cpp``, ``bmp.py``) against ``cv2.imread(path,
cv2.IMREAD_COLOR)``, bit for bit, on the CPU.

* PNG: every colour type at every bit depth it allows, straight and Adam7
  interlaced, with each row's filter drawn from the five, written by the
  PNG writer below (which neither cv2 nor Pillow can be asked to do), and
  the files cv2 and Pillow write themselves.
* BMP: 1-, 4- and 8-bit palettes, 24 and 32 bits, bottom-up and top-down,
  the Windows and the OS/2 header; other compressions raise naming the
  header field.
* EXIF orientations 1-8, in a JPEG's APP1 (both byte orders) and a PNG's
  eXIf chunk: shape and bytes of ``cv2.imread``, which applies the tag.
  The training loader (``data/datasets.py:FrameReader`` and
  ``ImageDataset``) and the MOT ingestion's probed size
  (``ingest_mot.read_seqinfo``) are held to the JAX package's on such
  files: before the readers came they read JPEGs
  raw, and differed from the JAX package on every rotated image.
* The format is taken from the first bytes, not the name; GIF, TIFF and
  WebP raise ``NotImplementedError`` naming the format.
"""

import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from siammot_tpu.data.coco import CocoDataset as JaxCoco
from siammot_tpu.data.datasets import FrameReader as JaxFrameReader
from siammot_tpu.data.datasets import ImageDataset as JaxImageDataset
from siammot_tpu.data.ingestion.ingest_mot import \
    read_seqinfo as jax_read_seqinfo
from siammot_tpu_torch.data.coco import CocoDataset
from siammot_tpu_torch.data.datasets import FrameReader, ImageDataset
from siammot_tpu_torch.data.ingestion.ingest_mot import read_seqinfo


def cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert img is not None, path
    return img[..., ::-1]


def assert_reads_as_cv2(path):
    from siammot_tpu_torch.data import imageio
    want = cv2_rgb(path)
    got = imageio.imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, \
        (path, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert imageio.image_size(str(path)) == (want.shape[1], want.shape[0])


# -- a PNG writer that can write what the tests need -------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _pack_rows(samples, depth):
    """[h, w, n] samples -> [h, row_bytes] packed big-endian rows."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter_rows(rows, bpp, rng):
    """Each row under a filter type drawn from 0-4 (PNG spec, section 9)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        f = int(rng.randint(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8)
                   .tobytes())
        prev = row
    return b"".join(out)


def write_png(path, samples, ctype, depth, interlace, rng, palette=None,
              exif=None):
    h, w, n = samples.shape
    bpp = max(1, n * depth // 8)
    raw = b""
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack_rows(sub, depth), bpp, rng)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if exif is not None:
        data += _chunk(b"eXIf", exif)
    comp = zlib.compress(raw, 6)
    half = len(comp) // 2               # two IDAT chunks
    data += _chunk(b"IDAT", comp[:half]) + _chunk(b"IDAT", comp[half:])
    data += _chunk(b"IEND", b"")
    path.write_bytes(data)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_every_colour_type_and_depth_as_cv2(tmp_path, ctype, interlace):
    rng = np.random.RandomState(10 * ctype + interlace)
    for depth in DEPTHS[ctype]:
        for h, w in ((13, 17), (1, 1), (3, 9), (9, 2)):
            n = CHANNELS[ctype]
            top = (1 << depth) - 1
            palette = None
            if ctype == 3:
                k = int(rng.randint(1, top + 2))
                palette = rng.randint(0, 256, (k, 3))
                top = k - 1
            samples = rng.randint(0, top + 1, (h, w, n)).astype(
                np.uint16 if depth == 16 else np.uint8)
            path = tmp_path / f"c{ctype}_d{depth}_i{interlace}_{h}x{w}.png"
            write_png(path, samples, ctype, depth, interlace, rng, palette)
            assert_reads_as_cv2(path)


def test_png_written_by_cv2_and_pillow_as_cv2(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (21, 34, 4))
    files = []
    for name, arr in (("gray8", img[..., 0].astype(np.uint8)),
                      ("gray16", (img[..., 0] * 257).astype(np.uint16)),
                      ("bgr8", img[..., :3].astype(np.uint8)),
                      ("bgr16", (img[..., :3] * 251).astype(np.uint16)),
                      ("bgra8", img.astype(np.uint8)),
                      ("bgra16", (img * 255).astype(np.uint16))):
        p = tmp_path / f"cv2_{name}.png"
        cv2.imwrite(str(p), arr)
        files.append(p)
    pil = Image.fromarray(img[..., :3].astype(np.uint8))
    for mode, extra in (("1", {}), ("L", {}), ("LA", {}), ("RGB", {}),
                        ("RGBA", {}), ("I;16", {}), ("P", {"bits": 1}),
                        ("P", {"bits": 2}), ("P", {"bits": 4}),
                        ("P", {})):
        im = pil.convert(mode) if mode != "P" else pil.quantize(
            1 << extra.get("bits", 8))
        p = tmp_path / f"pil_{mode.replace(';', '')}_{len(files)}.png"
        im.save(p, **extra)
        files.append(p)
    for p in files:
        assert_reads_as_cv2(p)


# -- BMP ---------------------------------------------------------------------

def write_bmp(path, bpp, pixels, palette=None, top_down=False, core=False,
              compression=0):
    """pixels: [h, w] indices (bpp <= 8) or [h, w, 3|4] BGR(A) bytes."""
    h, w = pixels.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    rows = []
    for r in pixels:
        if bpp <= 8:
            bits = (r[:, None] >> np.arange(bpp - 1, -1, -1)) & 1
            row = np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes() \
                if bpp < 8 else r.astype(np.uint8).tobytes()
        else:
            row = r.astype(np.uint8).tobytes()
        rows.append(row.ljust(stride, b"\0"))
    if not top_down:
        rows = rows[::-1]
    entry = 3 if core else 4
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(int(v) for v in c[::-1])
                       + (b"" if core else b"\0") for c in palette)
    if core:
        dib = struct.pack("<IhhHH", 12, w, h, 1, bpp)
    else:
        dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                          bpp, compression, stride * h, 2835, 2835,
                          len(pal) // entry if palette is not None else 0, 0)
    offset = 14 + len(dib) + len(pal)
    body = b"".join(rows)
    path.write_bytes(b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0,
                                         offset) + dib + pal + body)


@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_every_depth_as_cv2(tmp_path, top_down):
    rng = np.random.RandomState(int(top_down))
    for bpp in (1, 4, 8, 24, 32):
        for h, w in ((11, 13), (1, 1), (7, 33)):
            for core in ((False, True) if bpp <= 8 and not top_down
                         else (False,)):
                palette = None
                if bpp <= 8:
                    k = 1 << bpp
                    palette = rng.randint(0, 256, (k, 3))
                    pixels = rng.randint(0, k, (h, w))
                else:
                    pixels = rng.randint(0, 256, (h, w, bpp // 8))
                path = tmp_path / f"b{bpp}_{h}x{w}_{int(core)}.bmp"
                write_bmp(path, bpp, pixels, palette, top_down, core)
                assert_reads_as_cv2(path)
    # the files cv2 writes itself: 24-bit colour, an 8-bit grey palette
    for name, arr in (("cv2_bgr.bmp", rng.randint(0, 256, (9, 14, 3))),
                      ("cv2_gray.bmp", rng.randint(0, 256, (9, 14)))):
        cv2.imwrite(str(tmp_path / name), arr.astype(np.uint8))
        assert_reads_as_cv2(tmp_path / name)


def test_bmp_compressions_raise_naming_the_field(tmp_path):
    from siammot_tpu_torch.data import imageio
    pixels = np.zeros((4, 4), np.int64)
    for comp, name in ((1, "BI_RLE8"), (2, "BI_RLE4"), (3, "BI_BITFIELDS")):
        path = tmp_path / f"c{comp}.bmp"
        write_bmp(path, 8, pixels, np.zeros((256, 3), np.int64),
                  compression=comp)
        with pytest.raises(NotImplementedError, match=f"biCompression.*"
                                                      f"{name}"):
            imageio.imread(str(path))


# -- EXIF --------------------------------------------------------------------

def exif_tiff(orientation, order="II"):
    """A TIFF stream whose IFD0 holds a Make tag and the Orientation."""
    e = "<" if order == "II" else ">"
    make = b"Maker\0"
    entries = [(0x010F, 2, len(make), 8 + 2 + 2 * 12 + 4),
               (0x0112, 3, 1, None)]
    out = order.encode() + struct.pack(e + "HI", 42, 8)
    out += struct.pack(e + "H", len(entries))
    for tag, kind, count, value in entries:
        out += struct.pack(e + "HHI", tag, kind, count)
        out += struct.pack(e + "I", value) if value is not None else \
            struct.pack(e + "HH", orientation, 0)
    return out + struct.pack(e + "I", 0) + make


def jpeg_with_exif(path, rgb, orientation, order):
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1])
    assert ok
    data = buf.tobytes()
    app1 = b"Exif\0\0" + exif_tiff(orientation, order)
    seg = b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
    path.write_bytes(data[:2] + seg + data[2:])


def oriented_stills(tmp_path):
    rng = np.random.RandomState(6)
    rgb = cv2.resize(rng.randint(0, 256, (5, 7, 3)).astype(np.uint8),
                     (30, 20), interpolation=cv2.INTER_LINEAR)
    paths = []
    for o in range(1, 9):
        for order in ("II", "MM"):
            p = tmp_path / f"o{o}_{order}.jpg"
            jpeg_with_exif(p, rgb, o, order)
            paths.append(p)
        ex = Image.Exif()
        ex[0x0112] = o
        p = tmp_path / f"o{o}_pil.jpg"
        Image.fromarray(rgb).save(p, exif=ex.tobytes(), quality=90)
        paths.append(p)
        p = tmp_path / f"o{o}.png"
        write_png(p, rgb, 2, 8, o % 2, rng, exif=exif_tiff(o, "MM"))
        paths.append(p)
    return paths


def test_exif_orientations_as_cv2(tmp_path):
    paths = oriented_stills(tmp_path)
    shapes = set()
    for p in paths:
        assert_reads_as_cv2(p)
        shapes.add(cv2.imread(str(p)).shape)
    assert shapes == {(20, 30, 3), (30, 20, 3)}


def test_training_reader_and_ingestion_apply_exif_as_jax(tmp_path):
    """The training loader's frames and the MOT ingestion's probed size of
    an oriented JPEG sequence equal the JAX package's (``cv2.imread``)."""
    rng = np.random.RandomState(8)
    rgb = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    seq = tmp_path / "SEQ"
    img1 = seq / "img1"
    img1.mkdir(parents=True)
    for i, o in enumerate((6, 1, 8, 3, 5)):
        jpeg_with_exif(img1 / f"{i + 1:06d}.jpg", rgb, o, "II" if i % 2
                       else "MM")
    port, jax = FrameReader(str(img1)), JaxFrameReader(str(img1))
    for i in range(5):
        want = jax[i]
        got = port[i]
        assert got.shape == want.shape, (i, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)
    assert read_seqinfo(str(seq)) == jax_read_seqinfo(str(seq))
    assert (read_seqinfo(str(seq))["width"],
            read_seqinfo(str(seq))["height"]) == (20, 30)
    # the image dataset (stills as pseudo-video), a PNG among the JPEGs
    write_png(img1 / "000006.png", rgb, 2, 8, 1, rng,
              exif=exif_tiff(8, "II"))
    names = sorted(os.listdir(img1))
    ann = tmp_path / "coco.json"
    ann.write_text(json.dumps(dict(
        images=[dict(id=i + 1, file_name=n, width=30, height=30)
                for i, n in enumerate(names)],
        annotations=[dict(id=i + 1, image_id=i + 1, category_id=1,
                          bbox=[2, 3, 9, 8], area=72, iscrowd=0)
                     for i in range(len(names))],
        categories=[dict(id=1, name="person")])))
    port = ImageDataset(CocoDataset(str(ann)), str(img1))
    jax = JaxImageDataset(JaxCoco(str(ann)), str(img1))
    assert len(port) == len(jax) == 6
    for i in range(6):
        (pf, _, pn), (jf, _, jn) = port[(i, 0)], jax[(i, 0)]
        assert pn == jn and pf[0].shape == jf[0].shape
        np.testing.assert_array_equal(pf[0], jf[0])


# -- sniffing ----------------------------------------------------------------

def test_format_from_magic_bytes_and_unsupported_formats(tmp_path):
    from siammot_tpu_torch.data import imageio
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (10, 12, 3)).astype(np.uint8)
    # the name says JPEG, the bytes PNG (and the other ways round)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    (tmp_path / "png_as.jpg").write_bytes((tmp_path / "a.png").read_bytes())
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    (tmp_path / "jpg_as.bmp").write_bytes((tmp_path / "a.jpg").read_bytes())
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    (tmp_path / "bmp_as.png").write_bytes((tmp_path / "a.bmp").read_bytes())
    for name in ("png_as.jpg", "jpg_as.bmp", "bmp_as.png"):
        assert_reads_as_cv2(tmp_path / name)
    pil = Image.fromarray(img)
    for fmt, name in (("GIF", "GIF"), ("TIFF", "TIFF"), ("WEBP", "WebP")):
        buf = io.BytesIO()
        pil.save(buf, format=fmt)
        p = tmp_path / f"x.{fmt.lower()}"
        p.write_bytes(buf.getvalue())
        with pytest.raises(NotImplementedError, match=name):
            imageio.imread(str(p))
    (tmp_path / "zero.jpg").write_bytes(b"\0" * 32)
    with pytest.raises(NotImplementedError, match="does not know"):
        imageio.imread(str(tmp_path / "zero.jpg"))
    # a damaged PNG chunk fails its CRC, as libpng's check fails it
    data = bytearray((tmp_path / "a.png").read_bytes())
    data[40] ^= 0xFF
    (tmp_path / "bad.png").write_bytes(bytes(data))
    assert cv2.imread(str(tmp_path / "bad.png")) is None
    with pytest.raises(IOError, match="CRC"):
        imageio.imread(str(tmp_path / "bad.png"))
