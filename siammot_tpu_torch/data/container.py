"""Video files for the port, without ``cv2`` or FFmpeg: a demuxer for AVI
and ISO BMFF (MP4, MOV) that hands each frame's packet to the port's JPEG
decoder (``data/native.py``: libjpeg on the CPU, nvJPEG on the card).

The card's machine has no video decoder library, so the port decodes
Motion JPEG only, where every packet is a JPEG image:

  * AVI (RIFF ``AVI ``): ``avih`` and the video stream's ``strh`` and
    ``strf`` give the rate, frame count and size; the packets are the
    stream's ``##dc``/``##db`` chunks of ``movi``, in ``idx1`` order where
    that index is there (and the file holds one RIFF), else in file order
    over every ``movi`` list.  Codec: ``MJPG`` and the other fourccs
    FFmpeg maps to its MJPEG decoder.
  * MP4 and MOV: the first video track's ``stsd``, ``stsz``, ``stsc``,
    ``stco``/``co64`` and ``stts`` give the packets and their durations,
    ``mdhd`` the timescale, ``tkhd``'s display matrix the rotation (0, 90,
    180 or 270, as FFmpeg's ``av_display_rotation_get`` reads it).
    Codec: the ``jpeg``, ``mjpa`` and ``mjpb`` sample entries (a Motion
    JPEG format B field, whose segments carry no markers and whose scan
    no stuffed bytes, is rebuilt as a JPEG stream first:
    :func:`mjpeg_b_to_jpeg`), and ``mp4v`` whose ``esds`` object type is
    0x6C (JPEG), which is how FFmpeg, and so ``cv2.VideoWriter``, stores
    MJPEG in an MP4.

Any other codec (H.264, MPEG-4 Part 2, ...) raises
``NotImplementedError`` naming it.  Some MJPEG packets leave out
their Huffman tables (DHT) and rely on the standard ones (JPEG Annex K.3,
which libjpeg would also assume); :func:`with_huffman_tables` inserts them
before decoding, so nvJPEG reads such packets too.
"""

from __future__ import annotations

import contextlib
import math
import mmap
import struct

import numpy as np

from . import native

# fourccs FFmpeg's AVI demuxer maps to its MJPEG decoder (libavformat
# riff.c), upper-cased
AVI_MJPEG = {"MJPG", "AVRN", "ACDV", "QIVG", "SLMJ", "CJPG", "IJPG", "AVMJ",
             "AVI1", "AVI2", "MTSJ", "ZJPG", "MMJP", "DMB1", "MJPA", "JPEG"}
MP4_MJPEG = {"jpeg", "mjpa", "mjpb"}
OBJECT_JPEG = 0x6C
OBJECT_TYPES = {0x20: "MPEG-4 Part 2 (Visual)", 0x21: "H.264", 0x23: "HEVC",
                0x60: "MPEG-2 Video", 0x61: "MPEG-2 Video",
                0x6A: "MPEG-1 Video", 0x6C: "JPEG", 0x6D: "PNG",
                0x6E: "JPEG 2000"}
CODEC_NAMES = {"avc1": "H.264", "avc3": "H.264", "hvc1": "HEVC",
               "hev1": "HEVC", "vp09": "VP9", "av01": "AV1", "mp4v":
               "MPEG-4 Part 2", "H264": "H.264", "X264": "H.264", "XVID": "MPEG-4 Part 2",
               "DIVX": "MPEG-4 Part 2", "FMP4": "MPEG-4 Part 2",
               "MP4V": "MPEG-4 Part 2"}


def no_decoder(path: str, codec: str) -> NotImplementedError:
    name = CODEC_NAMES.get(codec.strip(), "")
    return NotImplementedError(
        f"{path}: codec {codec!r}{' (' + name + ')' if name else ''}: the "
        f"port decodes Motion JPEG only (every packet a JPEG image, through "
        f"libjpeg on the CPU or nvJPEG on the card); the card's machine has "
        f"no decoder for other codecs")


# -- the standard Huffman tables (JPEG Annex K.3) -------------------------

def _dht(table_class: int, table_id: int, bits, values) -> bytes:
    return bytes([table_class << 4 | table_id, *bits, *values])


_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
    "fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
_TABLES = b"".join((
    _dht(0, 0, (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), range(12)),
    _dht(1, 0, (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
         _AC_LUMA),
    _dht(0, 1, (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), range(12)),
    _dht(1, 1, (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
         _AC_CHROMA)))
STANDARD_DHT = b"\xff\xc4" + struct.pack(">H", 2 + len(_TABLES)) + _TABLES


def with_huffman_tables(packet: bytes) -> bytes:
    """``packet`` with the standard DHT segment inserted before its first
    scan if no DHT comes before it; else ``packet`` itself."""
    pos = 2
    while pos + 4 <= len(packet):
        if packet[pos] != 0xFF:
            break
        marker = packet[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xC4:
            return packet
        if marker == 0xDA:
            return packet[:pos] + STANDARD_DHT + packet[pos:]
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 2
            continue
        pos += 2 + struct.unpack(">H", packet[pos + 2:pos + 4])[0]
    raise IOError("a video packet is not a JPEG image (no start of scan)")


def mjpeg_b_to_jpeg(field: bytes) -> bytes:
    """A Motion JPEG format B field (QuickTime's ``mjpb``) as a JPEG
    stream.  The field starts with a 40-byte header: 4 zero bytes,
    ``mjpg``, the field size, its padded size, the second field's offset,
    then the offsets of the DQT, DHT, SOF and SOS segments (each a 2-byte
    length and a body, no marker; 0 where absent) and of the scan data,
    which is not byte-stuffed.  A second field (an interlaced frame) is
    not decoded."""
    if len(field) < 40 or field[4:8] != b"mjpg":
        raise IOError("an mjpb packet without its 'mjpg' header")
    size, _, _, dqt, dht, sof, sos, sod = struct.unpack(">8I", field[8:40])
    out = [b"\xff\xd8"]
    for marker, at in ((0xDB, dqt), (0xC4, dht), (0xC0, sof), (0xDA, sos)):
        if at:
            n, = struct.unpack(">H", field[at:at + 2])
            out.append(bytes([0xFF, marker]) + field[at:at + n])
    end = min(size, len(field)) if size else len(field)
    out.append(field[sod:end].replace(b"\xff", b"\xff\x00"))
    out.append(b"\xff\xd9")
    return b"".join(out)


# -- the container -----------------------------------------------------------

class Video:
    """A demuxed MJPEG video: ``fps``, ``frame_count``, ``width``,
    ``height``, ``rotation`` (degrees, 0/90/180/270) and ``codec``; the
    packets by index (random access) as (file offset, size)."""

    def __init__(self, path: str, fps: float, width: int, height: int,
                 rotation: int, codec: str, spans: list):
        self.path = path
        self.fps = fps
        self.width = width
        self.height = height
        self.rotation = rotation
        self.codec = codec
        self.spans = spans

    @property
    def frame_count(self) -> int:
        return len(self.spans)

    def _read(self, f, idx: int) -> bytes:
        offset, size = self.spans[idx]
        f.seek(offset)
        data = f.read(size)
        if len(data) != size:
            raise IOError(f"{self.path}: packet {idx} ends past the file")
        return data

    def packet(self, idx: int) -> bytes:
        with open(self.path, "rb") as f:
            return self._read(f, idx)

    def packets(self):
        with open(self.path, "rb") as f:
            for idx in range(len(self.spans)):
                yield self._read(f, idx)

    def decode(self, packet: bytes, device="cpu", what=None) -> np.ndarray:
        """One packet -> uint8 [h, w, 3] RGB as stored (no rotation)."""
        what = what or self.path
        if self.codec == "mjpb":
            packet = mjpeg_b_to_jpeg(packet)
        img = native.decode_jpeg_bytes(with_huffman_tables(packet), device,
                                       what)
        if img.shape[:2] != (self.height, self.width):
            raise IOError(f"{what}: a {img.shape[1]}x{img.shape[0]} frame in "
                          f"a {self.width}x{self.height} stream (a packet of "
                          f"two interlaced fields?)")
        return img

    def frame(self, idx: int, device="cpu") -> np.ndarray:
        return self.decode(self.packet(idx), device,
                           f"{self.path} frame {idx}")

    def frames(self, device="cpu"):
        """Yield every frame in order, turned upright by the container's
        rotation (as OpenCV's FFmpeg backend turns them by default)."""
        for i, data in enumerate(self.packets()):
            yield apply_rotation(
                self.decode(data, device, f"{self.path} frame {i}"),
                self.rotation)

    def metadata(self) -> dict:
        """The JAX package's ``video_metadata`` keys; the size upright."""
        w, h = (self.height, self.width) if self.rotation % 180 \
            else (self.width, self.height)
        return dict(fps=self.fps, number_of_frames=self.frame_count,
                    resolution={"width": w, "height": h})


def apply_rotation(frame: np.ndarray, rotation: int) -> np.ndarray:
    """Turn a decoded frame upright: ``np.rot90(frame, k=(-(rotation //
    90)) % 4)``, a clockwise turn by ``rotation`` degrees (the JAX demo's
    rule, and OpenCV's automatic orientation)."""
    if rotation > 0:
        frame = np.ascontiguousarray(np.rot90(frame, k=(-(rotation // 90))
                                              % 4))
    return frame


def open_video(path: str) -> Video:
    """Demux ``path`` (AVI, MP4 or MOV, chosen by its first bytes)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) == 12 and head[:4] == b"RIFF" \
                and head[8:12] == b"AVI ":
            demux = _open_avi
        elif len(head) == 12 and head[4:8] in (b"ftyp", b"moov", b"mdat",
                                                b"free", b"wide", b"skip"):
            demux = _open_mp4
        else:
            raise NotImplementedError(
                f"{path}: not an AVI, MP4 or MOV file (first bytes "
                f"{head.hex()}); the port reads MJPEG in those containers "
                f"only")
        with contextlib.closing(mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ)) as data:
            return demux(path, data)


# -- AVI ---------------------------------------------------------------------

def _riff_chunks(data, start, end):
    """Yield (fourcc, list type or None, body start, body end)."""
    pos = start
    while pos + 8 <= end:
        cc = data[pos:pos + 4]
        size, = struct.unpack("<I", data[pos + 4:pos + 8])
        body = pos + 8
        if cc in (b"RIFF", b"LIST"):
            yield cc, data[body:body + 4], body + 4, min(body + size, end)
        else:
            yield cc, None, body, min(body + size, end)
        pos = body + size + (size & 1)


def _open_avi(path: str, data) -> Video:
    n = len(data)
    riffs = [(s, e) for cc, kind, s, e in _riff_chunks(data, 0, n)
             if cc == b"RIFF" and kind in (b"AVI ", b"AVIX")]
    if not riffs:
        raise IOError(f"{path}: a truncated AVI file")
    first_s, first_e = riffs[0]
    stream, video, avih = 0, None, None
    movi, idx1 = [], None
    for cc, kind, s, e in _riff_chunks(data, first_s, first_e):
        if kind == b"hdrl":
            for cc2, kind2, s2, e2 in _riff_chunks(data, s, e):
                if cc2 == b"avih":
                    avih = struct.unpack("<10I", data[s2:s2 + 40])
                elif kind2 == b"strl":
                    strh = strf = None
                    for cc3, _, s3, e3 in _riff_chunks(data, s2, e2):
                        if cc3 == b"strh":
                            strh = bytes(data[s3:e3])
                        elif cc3 == b"strf":
                            strf = bytes(data[s3:e3])
                    if video is None and strh and strh[:4] == b"vids":
                        video = (stream, strh, strf)
                    stream += 1
        elif kind == b"movi":
            movi.append((s, e))
        elif cc == b"idx1":
            idx1 = (s, e)
    for s, e in riffs[1:]:
        movi += [(s2, e2) for _, kind, s2, e2 in _riff_chunks(data, s, e)
                 if kind == b"movi"]
    if video is None or not movi:
        raise IOError(f"{path}: an AVI file without a video stream or movi")
    index, strh, strf = video
    # the codec: strf's biCompression, as FFmpeg reads it
    codec = (strf[16:20] if strf and len(strf) >= 20 else strh[4:8]) \
        .decode("latin-1")
    if codec.upper() not in AVI_MJPEG:
        raise no_decoder(path, codec)
    scale, rate = struct.unpack("<II", strh[20:28])
    if strf and len(strf) >= 12:
        width, height = struct.unpack("<ii", strf[4:12])
    else:
        width, height = avih[8], avih[9]
    ids = (f"{index:02d}dc".encode(), f"{index:02d}db".encode())
    spans = None
    if idx1 is not None and len(riffs) == 1:
        spans = _avi_index(data, idx1, movi[0][0] - 4, ids)
    if spans is None:
        spans = []
        for s, e in movi:
            _scan_movi(data, s, e, ids, spans)
    if scale:
        fps = rate / scale
    else:
        fps = 1e6 / avih[0] if avih and avih[0] else 30.0
    return Video(path, float(fps), int(width), abs(int(height)), 0, codec,
                 spans)


def _avi_index(data, idx1, movi_fourcc, ids):
    """Packets from ``idx1``, whose offsets count from the ``movi`` fourcc
    or from the start of the file; None if neither fits."""
    s, e = idx1
    entries = [struct.unpack("<4sIII", data[p:p + 16])
               for p in range(s, e - 15, 16)]
    video = [(off, size) for cc, _, off, size in entries if cc in ids]
    if not video:
        return None
    for base in (movi_fourcc, 0):
        off, _ = video[0]
        if data[base + off:base + off + 4] in ids:
            return [(base + off + 8, size) for off, size in video if size]
    return None


def _scan_movi(data, s, e, ids, spans):
    for cc, kind, s2, e2 in _riff_chunks(data, s, e):
        if kind == b"rec ":
            _scan_movi(data, s2, e2, ids, spans)
        elif cc in ids and e2 > s2:
            spans.append((s2, e2 - s2))


# -- ISO BMFF ----------------------------------------------------------------

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf",
              b"udta"}


def _boxes(data, start, end):
    """Yield (type, body start, body end) of the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size, = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            break
        yield kind, pos + head, min(pos + size, end)
        pos += size


def _child(data, s, e, kind):
    for k, s2, e2 in _boxes(data, s, e):
        if k == kind:
            return s2, e2
    return None


def _descriptor(data, pos):
    """(tag, body start, body end) of an MPEG-4 descriptor at ``pos``."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = size << 7 | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def object_type(data, s, e):
    """The ``objectTypeIndication`` of an ``esds`` box's decoder config,
    or None."""
    tag, p, end = _descriptor(data, s + 4)      # past version and flags
    if tag != 0x03:
        return None
    flags = data[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + data[p]
    if flags & 0x20:
        p += 2
    tag, p, _ = _descriptor(data, p)
    return data[p] if tag == 0x04 else None


def display_rotation(matrix) -> int:
    """The rotation of a ``tkhd`` display matrix as OpenCV's FFmpeg backend
    reports it (``CAP_PROP_ORIENTATION_META``): the angle of the matrix's
    first column, rounded, in [0, 360)."""
    a, b, _, c, d = (v / 65536.0 for v in matrix[:5])
    s0, s1 = math.hypot(a, c), math.hypot(b, d)
    if s0 == 0 or s1 == 0:
        return 0
    deg = math.atan2(b / s1, a / s0) * 180 / math.pi
    return int(np.rint(deg)) % 360


def _open_mp4(path: str, data) -> Video:
    moov = _child(data, 0, len(data), b"moov")
    if moov is None:
        raise IOError(f"{path}: an MP4/MOV file without moov")
    for kind, s, e in _boxes(data, *moov):
        if kind != b"trak":
            continue
        mdia = _child(data, s, e, b"mdia")
        hdlr = mdia and _child(data, *mdia, b"hdlr")
        if not hdlr or data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _mp4_track(path, data, (s, e), mdia)
    raise IOError(f"{path}: an MP4/MOV file without a video track")


def _mp4_track(path, data, trak, mdia) -> Video:
    tkhd = _child(data, *trak, b"tkhd")
    version = data[tkhd[0]]
    mat_at = tkhd[0] + (52 if version == 1 else 40)
    matrix = struct.unpack(">9i", data[mat_at:mat_at + 36])
    mdhd = _child(data, *mdia, b"mdhd")
    timescale, = struct.unpack_from(
        ">I", data, mdhd[0] + (20 if data[mdhd[0]] == 1 else 12))
    minf = _child(data, *mdia, b"minf")
    stbl = _child(data, *minf, b"stbl")
    box = {k: _child(data, *stbl, k) for k in (b"stsd", b"stts", b"stsc",
                                              b"stsz", b"stco", b"co64")}
    s, _ = box[b"stsd"]
    entry = s + 8                                   # version, flags, count
    size, fmt = struct.unpack(">I4s", data[entry:entry + 8])
    codec = fmt.decode("latin-1")
    width, height = struct.unpack(">HH", data[entry + 32:entry + 36])
    if codec == "mp4v":
        esds = _child(data, entry + 86, entry + size, b"esds")
        oti = object_type(data, *esds) if esds else None
        if oti != OBJECT_JPEG:
            name = OBJECT_TYPES.get(oti, "unknown")
            raise no_decoder(path, f"mp4v, object type "
                                   f"{'none' if oti is None else hex(oti)} "
                                   f"({name})")
    elif codec not in MP4_MJPEG:
        raise no_decoder(path, codec)
    spans = _mp4_samples(data, box)
    s, _ = box[b"stts"]
    n, = struct.unpack(">I", data[s + 4:s + 8])
    runs = [struct.unpack(">II", data[s + 8 + 8 * i:s + 16 + 8 * i])
            for i in range(n)]
    total = sum(count * delta for count, delta in runs)
    count = sum(c for c, _ in runs)
    fps = timescale * count / total if total else 30.0
    return Video(path, float(fps), int(width), int(height),
                 display_rotation(matrix), codec, spans)


def _mp4_samples(data, box) -> list:
    s, _ = box[b"stsz"]
    fixed, n = struct.unpack(">II", data[s + 4:s + 12])
    sizes = [fixed] * n if fixed else list(
        struct.unpack(f">{n}I", data[s + 12:s + 12 + 4 * n]))
    if box[b"co64"] is not None:
        s, _ = box[b"co64"]
        m, = struct.unpack(">I", data[s + 4:s + 8])
        chunks = struct.unpack(f">{m}Q", data[s + 8:s + 8 + 8 * m])
    else:
        s, _ = box[b"stco"]
        m, = struct.unpack(">I", data[s + 4:s + 8])
        chunks = struct.unpack(f">{m}I", data[s + 8:s + 8 + 4 * m])
    s, _ = box[b"stsc"]
    k, = struct.unpack(">I", data[s + 4:s + 8])
    runs = [struct.unpack(">III", data[s + 8 + 12 * i:s + 20 + 12 * i])
            for i in range(k)]
    spans, sample = [], 0
    for r, (first, per_chunk, _) in enumerate(runs):
        last = runs[r + 1][0] - 1 if r + 1 < k else m
        for chunk in range(first - 1, last):
            offset = chunks[chunk]
            for _ in range(per_chunk):
                if sample >= n:
                    return spans
                spans.append((offset, sizes[sample]))
                offset += sizes[sample]
                sample += 1
    if sample != n:
        raise IOError(f"the sample table places {sample} of {n} samples")
    return spans



# -- writing: MJPEG in an MP4 ------------------------------------------------

def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descr(tag: int, body: bytes) -> bytes:
    n = len(body)
    size = bytes([0x80 | (n >> 21 & 0x7F), 0x80 | (n >> 14 & 0x7F),
                  0x80 | (n >> 7 & 0x7F), n & 0x7F])
    return bytes([tag]) + size + body


IDENTITY = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                       0x40000000)


class Mp4Writer:
    """Write JPEG packets as an MJPEG video in an MP4: one track, an
    ``mp4v`` sample entry whose ``esds`` object type is 0x6C (JPEG), as
    FFmpeg (and so ``cv2.VideoWriter``) stores MJPEG in an MP4; one sample
    a chunk, a constant frame duration.  The samples stream into ``mdat``
    (64-bit size) and ``moov`` follows at :meth:`close`."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        self.path = path
        self.width, self.height = int(width), int(height)
        # fps as timescale / duration, to a thousandth of a frame a second
        self.timescale = max(1, int(round(fps * 1000)))
        self.delta = 1000
        self.sizes, self.offsets = [], []
        self._f = open(path, "wb")
        self._f.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                           b"isomiso2mp41"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 0))

    def write(self, packet: bytes) -> None:
        self.offsets.append(self._f.tell())
        self.sizes.append(len(packet))
        self._f.write(packet)

    def close(self) -> None:
        if self._f is None:
            return
        end = self._f.tell()
        self._f.seek(self._mdat + 8)
        self._f.write(struct.pack(">Q", end - self._mdat))
        self._f.seek(end)
        self._f.write(self._moov())
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _moov(self) -> bytes:
        n, w, h = len(self.sizes), self.width, self.height
        duration = n * self.delta                    # in the track's scale
        movie = int(round(duration * 1000 / self.timescale))   # in ms
        mvhd = _full(b"mvhd", 0, 0, struct.pack(
            ">IIIIIH10x", 0, 0, 1000, movie, 0x10000, 0x100), IDENTITY,
            bytes(24), struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(
            ">IIIII8xHHHxx", 0, 0, 1, 0, movie, 0, 0, 0), IDENTITY,
            struct.pack(">II", w << 16, h << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, self.timescale, duration, 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                     b"VideoHandler\0")
        esds = _full(b"esds", 0, 0, _descr(0x03, struct.pack(">HB", 1, 0)
                     + _descr(0x04, struct.pack(
                         ">BB3sII", OBJECT_JPEG, 0x11, (0).to_bytes(3, "big"),
                         0, 0)) + _descr(0x06, b"\x02")))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                     bytes(32), struct.pack(">Hh", 24, -1), esds)
        co64 = bool(self.offsets) and self.offsets[-1] > 0xFFFFFFFF
        stbl = _box(
            b"stbl",
            _full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta)),
            _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
            _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes)),
            _full(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *self.offsets))
            if co64 else
            _full(b"stco", 0, 0, struct.pack(f">I{n}I", n, *self.offsets)))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                    _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full(b"url ", 0, 1))), stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)
