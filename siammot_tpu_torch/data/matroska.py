"""Matroska and WebM for the port, without ``cv2`` or FFmpeg: an EBML
demuxer that gives ``data/container.py``'s :class:`~.container.Video`, so
the frames decode on the device's route as an MP4's do.

What it reads:

  * The EBML header (DocType ``matroska`` or ``webm``), then the Segment's
    Info (``TimestampScale``, default 1,000,000 ns, and ``Duration``), its
    Tracks (the first track of ``TrackType`` 1: ``CodecID``,
    ``CodecPrivate``, ``PixelWidth``/``PixelHeight``, ``DefaultDuration``,
    ``Video/Projection``'s poses as the rotation, and
    ``ContentEncodings``) and its Clusters (``Timestamp``, then
    ``SimpleBlock`` and ``BlockGroup``/``Block`` of that track).  IDs and
    sizes are EBML variable-length integers.
  * A Segment or Cluster of unknown size (all size bits set), as live
    recorders (a browser's MediaRecorder, OBS) write them, often with no
    ``Cues`` and no ``Duration``: a Cluster ends at the first element that
    cannot be its child, the Segment at the end of the file.
  * Lacing (Xiph, EBML and fixed): one packet per laced frame, each laced
    frame after the first ``DefaultDuration`` later.
  * Header stripping (``ContentCompAlgo`` 3): ``ContentCompSettings`` goes
    back in front of each frame.  zlib, bzlib, LZO and encryption raise,
    naming what they are.

Keyframes: a ``SimpleBlock`` whose flags have 0x80, a ``Block`` without
``ReferenceBlock``; for HEVC, VP8, VP9 and AV1 also a keyframe by its own
header (``container.stream_keys``).  Display order: the blocks sorted by
timestamp, ties kept in file order (H.264 and HEVC with B-frames store
their blocks in decode order, stamped with presentation times).

Metadata, as the JAX package's ``video_metadata`` reads it through
OpenCV's FFmpeg backend (``cap_ffmpeg_impl.hpp``):

  * ``CAP_PROP_FPS``: with ``DefaultDuration``, the rate FFmpeg's
    ``matroskadec`` makes of it, ``av_reduce(1e9, DefaultDuration,
    30000)`` (a CPU run of cv2 reported it at 1 to 2000 fps); without it
    FFmpeg estimates the rate from the timestamps, and the port takes the
    mean frame interval, snapped to the nearest rate FFmpeg's estimate
    chooses from (n/12 and the NTSC rates).
  * ``CAP_PROP_FRAME_COUNT``: Matroska stores no frame count, so OpenCV
    estimates it as ``floor(duration_s * fps + 0.5)`` (``get_total_frames``)
    from FFmpeg's ``duration`` (``Duration``); without ``Duration`` that
    duration is unset, OpenCV falls back to the stream's unset duration
    (INT64_MIN) in its time base and the estimate is a large negative
    number, which the port reproduces.
  * The rotation: ``matroskadec`` turns ``ProjectionPoseRoll`` into a
    display matrix (yaw 0 or 180 only, pitch 0), read as the MP4 demuxer
    reads ``tkhd``'s.
"""

from __future__ import annotations

import math
import struct
from fractions import Fraction

from . import codecs
from .container import (AV1, AVI_H264, AVI_MJPEG, AVI_MPEG4, H264, HEVC,
                        MJPEG, MPEG4, VP8, VP9, Video, _avcc, _refuse_packed,
                        display_rotation, no_decoder, stream_keys)

EBML, DOC_TYPE = 0x1A45DFA3, 0x4282
SEGMENT = 0x18538067
INFO, TIMESTAMP_SCALE, DURATION = 0x1549A966, 0x2AD7B1, 0x4489
TRACKS, TRACK_ENTRY = 0x1654AE6B, 0xAE
TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = 0xD7, 0x83, 0x86, 0x63A2
DEFAULT_DURATION = 0x23E383
VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT = 0xE0, 0xB0, 0xBA
PROJECTION, POSE_YAW, POSE_PITCH, POSE_ROLL = 0x7670, 0x7673, 0x7674, 0x7675
CONTENT_ENCODINGS, CONTENT_ENCODING = 0x6D80, 0x6240
ENCODING_SCOPE, ENCODING_TYPE = 0x5032, 0x5033
COMPRESSION, COMP_ALGO, COMP_SETTINGS = 0x5034, 0x4254, 0x4255
CLUSTER, CLUSTER_TIMESTAMP = 0x1F43B675, 0xE7
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, REFERENCE_BLOCK = 0xA3, 0xA0, 0xA1, 0xFB
VOID, CRC32 = 0xEC, 0xBF
# the elements a Cluster may hold: any other ends an unknown-size Cluster
CLUSTER_CHILDREN = {CLUSTER_TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, 0x5854,
                    0xA7, 0xAB, 0xAF, VOID, CRC32}
COMP_NAMES = {0: "zlib", 1: "bzlib", 2: "LZO (lzo1x)"}
# the rates FFmpeg's frame-rate estimate chooses from (libavformat
# ff_rfps_calculate): n/12 for n up to 60 * 12, and the NTSC rates
STANDARD_RATES = sorted({Fraction(n, 12) for n in range(1, 721)}
                        | {Fraction(r * 1000, 1001) for r in (24, 30, 60,
                                                              12, 15, 48)})
INT64_MIN = -(1 << 63)
EPS_ZERO = 0.000025                     # OpenCV's cap_ffmpeg_impl.hpp


def _vint(data, pos: int, marker: bool) -> tuple:
    """An EBML variable-length integer at ``pos``: (value, length,
    all-ones); ``marker`` keeps the length marker (element IDs)."""
    if pos >= len(data):
        raise IOError("an EBML element runs past the end of the file")
    first = data[pos]
    if first == 0:
        raise IOError(f"an EBML integer longer than 8 bytes at byte {pos}")
    length = 9 - first.bit_length()
    value = first if marker else first & (0xFF >> length)
    for i in range(1, length):
        value = value << 8 | data[pos + i]
    ones = not marker and value == (1 << (7 * length)) - 1
    return value, length, ones


def _element(data, pos: int) -> tuple:
    """(ID, body start, body size or None for an unknown size)."""
    eid, n, _ = _vint(data, pos, True)
    size, m, unknown = _vint(data, pos + n, False)
    return eid, pos + n + m, None if unknown else size


def _children(data, start: int, end: int):
    """Yield (ID, body start, body end) of the elements in [start, end);
    an unknown-size Cluster ends at the first element it cannot hold."""
    pos = start
    while pos < end:
        eid, body, size = _element(data, pos)
        if size is None:
            if eid != CLUSTER:
                raise IOError(f"an element 0x{eid:X} of unknown size at byte "
                              f"{pos}")
            stop = _cluster_end(data, body, end)
        else:
            stop = body + size
            if stop > end:
                stop = end              # a truncated file: keep what is there
        yield eid, body, stop
        pos = stop


def _cluster_end(data, body: int, end: int) -> int:
    pos = body
    while pos < end:
        eid, child, size = _element(data, pos)
        if eid not in CLUSTER_CHILDREN or size is None:
            return pos
        pos = child + size
    return end


def _uint(data, s: int, e: int) -> int:
    return int.from_bytes(data[s:e], "big")


def _float(data, s: int, e: int) -> float:
    if e - s == 4:
        return struct.unpack(">f", data[s:e])[0]
    if e - s == 8:
        return struct.unpack(">d", data[s:e])[0]
    return 0.0


def _find(data, s: int, e: int, eid: int):
    for k, s2, e2 in _children(data, s, e):
        if k == eid:
            return s2, e2
    return None


def av_reduce(num: int, den: int, limit: int) -> tuple:
    """FFmpeg's ``av_reduce``: the fraction nearest ``num / den`` whose
    terms do not pass ``limit`` (a continued-fraction walk)."""
    a0, a1 = (0, 1), (1, 0)
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
        nxt = num - den * x
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, a2
        num, den = den, nxt
    return a1


def projection_rotation(yaw: float, pitch: float, roll: float) -> int:
    """The rotation OpenCV reports for a track's projection poses: FFmpeg's
    ``mkv_create_display_matrix`` (a clockwise turn by -roll, mirrored
    where yaw is 180) read as a ``tkhd`` display matrix is read."""
    if (yaw, pitch, roll) == (0.0, 0.0, 0.0) or pitch != 0.0 \
            or yaw not in (0.0, 180.0, -180.0) or math.isnan(roll):
        return 0
    hflip = yaw != 0.0
    radians = -(roll * (2 * hflip - 1)) * math.pi / 180.0
    c, s = math.cos(radians), math.sin(radians)
    matrix = [int(c * 65536), int(-s * 65536), 0, int(s * 65536),
              int(c * 65536), 0, 0, 0, 1 << 30]
    if hflip:
        for i in (0, 3, 6):
            matrix[i] = -matrix[i]
    return display_rotation(matrix)


def _lace_sizes(data, pos: int, end: int, lacing: int) -> tuple:
    """(frame sizes, first frame's start) of a laced block's payload."""
    count = data[pos] + 1
    pos += 1
    sizes = []
    if lacing == 1:                                     # Xiph
        for _ in range(count - 1):
            size = 0
            while True:
                b = data[pos]
                pos += 1
                size += b
                if b != 255:
                    break
            sizes.append(size)
    elif lacing == 3:                                   # EBML
        size, n, _ = _vint(data, pos, False)
        pos += n
        sizes.append(size)
        for _ in range(count - 2):
            raw, n, _ = _vint(data, pos, False)
            pos += n
            size += raw - ((1 << (7 * n - 1)) - 1)      # signed difference
            sizes.append(size)
    else:                                               # fixed
        each, rest = divmod(end - pos, count)
        if rest:
            raise IOError("a fixed-size lace that does not divide its block")
        return [each] * count, pos
    sizes.append(end - pos - sum(sizes))
    if min(sizes) < 0:
        raise IOError("a laced block whose frames run past it")
    return sizes, pos


class _Track:
    def __init__(self):
        self.number = self.type = None
        self.codec_id, self.private = "", b""
        self.width = self.height = 0
        self.default_duration = 0
        self.pose = (0.0, 0.0, 0.0)
        self.encodings = []             # (scope, type, algo, settings)


def _track(data, s: int, e: int) -> _Track:
    t = _Track()
    for eid, s2, e2 in _children(data, s, e):
        if eid == TRACK_NUMBER:
            t.number = _uint(data, s2, e2)
        elif eid == TRACK_TYPE:
            t.type = _uint(data, s2, e2)
        elif eid == CODEC_ID:
            t.codec_id = bytes(data[s2:e2]).rstrip(b"\0").decode("latin-1")
        elif eid == CODEC_PRIVATE:
            t.private = bytes(data[s2:e2])
        elif eid == DEFAULT_DURATION:
            t.default_duration = _uint(data, s2, e2)
        elif eid == VIDEO:
            for k, s3, e3 in _children(data, s2, e2):
                if k == PIXEL_WIDTH:
                    t.width = _uint(data, s3, e3)
                elif k == PIXEL_HEIGHT:
                    t.height = _uint(data, s3, e3)
                elif k == PROJECTION:
                    pose = {POSE_YAW: 0.0, POSE_PITCH: 0.0, POSE_ROLL: 0.0}
                    for k4, s4, e4 in _children(data, s3, e3):
                        if k4 in pose:
                            pose[k4] = _float(data, s4, e4)
                    t.pose = (pose[POSE_YAW], pose[POSE_PITCH],
                              pose[POSE_ROLL])
        elif eid == CONTENT_ENCODINGS:
            for k, s3, e3 in _children(data, s2, e2):
                if k != CONTENT_ENCODING:
                    continue
                enc = {ENCODING_SCOPE: 1, ENCODING_TYPE: 0}
                algo, settings = 0, b""
                for k4, s4, e4 in _children(data, s3, e3):
                    if k4 in enc:
                        enc[k4] = _uint(data, s4, e4)
                    elif k4 == COMPRESSION:
                        for k5, s5, e5 in _children(data, s4, e4):
                            if k5 == COMP_ALGO:
                                algo = _uint(data, s5, e5)
                            elif k5 == COMP_SETTINGS:
                                settings = bytes(data[s5:e5])
                t.encodings.append((enc[ENCODING_SCOPE], enc[ENCODING_TYPE],
                                    algo, settings))
    return t


def _stripped_header(path: str, t: _Track) -> bytes:
    """The bytes header stripping took off each frame (b"": none); any
    other content encoding raises, naming it.  A CodecPrivate stripped as
    well gets them back here."""
    prefix = b""
    for scope, kind, algo, settings in t.encodings:
        if kind == 1:
            raise NotImplementedError(
                f"{path}: track {t.number} ({t.codec_id}) is encrypted "
                f"(ContentEncryption): the port reads no encrypted track")
        if algo != 3:
            raise NotImplementedError(
                f"{path}: track {t.number} ({t.codec_id}) is compressed with "
                f"{COMP_NAMES.get(algo, f'algorithm {algo}')} "
                f"(ContentCompAlgo {algo}): the port undoes header "
                f"stripping (3) only")
        if prefix:
            raise NotImplementedError(f"{path}: two content encodings on "
                                      f"track {t.number}")
        if scope & 2:
            t.private = settings + t.private
        if scope & 1:
            prefix = settings
    return prefix


def _codec(path: str, t: _Track) -> tuple:
    """(format, codec name, header, NAL length size, (bit depth, chroma)
    or None) of a video track."""
    cid, private = t.codec_id, t.private
    if cid == "V_MJPEG":
        return MJPEG, cid, b"", 0, None
    if cid == "V_MS/VFW/FOURCC":
        if len(private) < 40:
            raise IOError(f"{path}: a V_MS/VFW/FOURCC track without its "
                          f"BITMAPINFOHEADER")
        fourcc = private[16:20].decode("latin-1")
        fmt = {**dict.fromkeys(AVI_MJPEG, MJPEG),
               **dict.fromkeys(AVI_H264, H264),
               **dict.fromkeys(AVI_MPEG4, MPEG4)}.get(fourcc.upper())
        if fmt is None:
            raise no_decoder(path, f"{cid} {fourcc}")
        return fmt, fourcc, private[40:] if fmt == MPEG4 else b"", 0, None
    if cid in ("V_MPEG4/ISO/ASP", "V_MPEG4/ISO/SP", "V_MPEG4/ISO/AP"):
        return MPEG4, cid, private, 0, None
    if cid == "V_MPEG4/ISO/AVC":
        header, nal_length = _avcc(private, 0, len(private))
        return H264, cid, header, nal_length, None
    if cid == "V_MPEGH/ISO/HEVC":
        header, nal_length = codecs.hvcc(private)
        return HEVC, cid, header, nal_length, None
    if cid == "V_VP8":
        return VP8, cid, b"", 0, (8, "4:2:0")
    if cid == "V_VP9":
        return VP9, cid, b"", 0, None
    if cid == "V_AV1":
        if not private:
            raise IOError(f"{path}: a V_AV1 track without its av1C "
                          f"CodecPrivate")
        config = codecs.av1c(private)
        return AV1, cid, config["obus"], 0, (config["depth"],
                                             config["chroma"])
    raise no_decoder(path, cid)


def _blocks(data, clusters, track: int, default_step: float):
    """(spans, timestamps, keyframe flags) of the track's frames, in file
    (decode) order."""
    spans, stamps, keys = [], [], []
    for s, e in clusters:
        cluster_ts = 0
        for eid, s2, e2 in _children(data, s, e):
            if eid == CLUSTER_TIMESTAMP:
                cluster_ts = _uint(data, s2, e2)
                continue
            if eid == SIMPLE_BLOCK:
                body, end, key = s2, e2, None
            elif eid == BLOCK_GROUP:
                block = _find(data, s2, e2, BLOCK)
                if block is None:
                    continue
                body, end = block
                key = _find(data, s2, e2, REFERENCE_BLOCK) is None
            else:
                continue
            number, n, _ = _vint(data, body, False)
            if number != track:
                continue
            rel, flags = struct.unpack(">hB", data[body + n:body + n + 3])
            if key is None:
                key = bool(flags & 0x80)
            pos = body + n + 3
            lacing = flags >> 1 & 3
            if lacing:
                sizes, pos = _lace_sizes(data, pos, end, lacing)
            else:
                sizes = [end - pos]
            for i, size in enumerate(sizes):
                spans.append((pos, size))
                stamps.append(cluster_ts + rel + i * default_step)
                keys.append(key)
                pos += size
    return spans, stamps, keys


def _frame_rate(t: _Track, stamps, scale: int) -> float:
    """``CAP_PROP_FPS``: see the module's docstring."""
    if t.default_duration:
        num, den = av_reduce(10 ** 9, t.default_duration, 30000)
        return num / den
    times = sorted(set(stamps))
    if len(times) < 2:
        return 30.0
    interval = Fraction(times[-1] - times[0]) / (len(times) - 1)
    rate = Fraction(10 ** 9) / (interval * scale)
    return float(min(STANDARD_RATES, key=lambda r: abs(r - rate)))


def _frame_total(duration: float, scale: int, fps: float) -> int:
    """``CAP_PROP_FRAME_COUNT``: see the module's docstring."""
    sec = 0.0
    if duration:
        # FFmpeg's ic->duration, in microseconds, truncated to an integer
        sec = int(duration * scale * 1000 / 1000000) / 1000000
    if sec < EPS_ZERO:
        tb = Fraction(scale, 10 ** 9)
        sec = float(INT64_MIN) * (tb.numerator / tb.denominator)
    return int(math.floor(sec * fps + 0.5))


def open_matroska(path: str, data) -> Video:
    """Demux the first video track of a Matroska or WebM file (``data``:
    its bytes, or a map of them)."""
    n = len(data)
    eid, body, size = _element(data, 0)
    if eid != EBML or size is None:
        raise IOError(f"{path}: no EBML header")
    doc = _find(data, body, body + size, DOC_TYPE)
    doc_type = bytes(data[doc[0]:doc[1]]).rstrip(b"\0").decode("latin-1") \
        if doc else "matroska"
    if doc_type not in ("matroska", "webm"):
        raise NotImplementedError(f"{path}: an EBML file of DocType "
                                  f"{doc_type!r}, not Matroska or WebM")
    pos = body + size
    while pos < n:
        eid, body, size = _element(data, pos)
        if eid == SEGMENT:
            break
        if size is None:
            raise IOError(f"{path}: an element 0x{eid:X} of unknown size "
                          f"before the Segment")
        pos = body + size
    else:
        raise IOError(f"{path}: a Matroska file without a Segment")
    seg_end = n if size is None else min(body + size, n)
    scale, duration, track, clusters = 1000000, 0.0, None, []
    for eid, s, e in _children(data, body, seg_end):
        if eid == INFO:
            for k, s2, e2 in _children(data, s, e):
                if k == TIMESTAMP_SCALE:
                    scale = _uint(data, s2, e2) or 1000000
                elif k == DURATION:
                    duration = _float(data, s2, e2)
        elif eid == TRACKS and track is None:
            for k, s2, e2 in _children(data, s, e):
                if k == TRACK_ENTRY:
                    t = _track(data, s2, e2)
                    if t.type == 1:
                        track = t
                        break
        elif eid == CLUSTER:
            clusters.append((s, e))
        elif eid == SEGMENT:
            break                       # a second, chained Segment
    if track is None:
        raise IOError(f"{path}: a Matroska file without a video track")
    prefix = _stripped_header(path, track)
    fmt, codec, header, nal_length, stream_format = _codec(path, track)
    step = track.default_duration / scale if track.default_duration else 0
    spans, stamps, keys = _blocks(data, clusters, track.number, step)
    if not spans:
        raise IOError(f"{path}: the video track has no frames")
    fps = _frame_rate(track, stamps, scale)
    rotation = projection_rotation(*track.pose)
    common = dict(prefix=prefix, frame_total=_frame_total(duration, scale,
                                                          fps))
    if fmt == MJPEG:
        return Video(path, fps, int(track.width), int(track.height),
                     rotation, codec, spans, **common)
    def read(i):
        return prefix + bytes(data[spans[i][0]:sum(spans[i])])

    order = sorted(range(len(spans)), key=lambda i: (stamps[i], i))
    if order == list(range(len(spans))):
        order = None
    sync, hidden = [i for i, k in enumerate(keys) if k], ()
    if fmt == MPEG4:
        _refuse_packed(path, codec, map(read, range(min(4, len(spans)))))
    elif fmt in (HEVC, VP8, VP9, AV1):
        sync, hidden = stream_keys(path, fmt, read, len(spans), sync,
                                   nal_length, header)
    return Video(path, fps, int(track.width), int(track.height), rotation,
                 codec, spans, fmt, sync=sync, order=order, header=header,
                 nal_length=nal_length, hidden=hidden,
                 stream_format=stream_format, **common)
