"""Write the Matroska, WebM, HEVC, VP8, VP9 and AV1 fixtures of the port's
readers into ``tests/fixtures/video/``.

    python tools/make_torch_container_fixtures.py [--out DIR]

Needs ``cv2`` and the encoders' shared libraries, bound here with ctypes
(no header is read): x264 (``libx264.so.164``, through
``make_torch_video_fixtures.py``), x265 (``libx265.so.199``) and libaom
(``libaom.so.3``).  The frames are ``siammot_tpu_torch/utils/synth.py``'s
sprite scene at 200x120, 25 fps.  It writes:

  * from ``cv2.VideoWriter`` (FFmpeg's muxers), 12 frames each (Motion
    JPEG 6): ``mjpeg_small.mkv`` (``MJPG``, ``V_MJPEG``), ``mpeg4_small.mkv``
    (``XVID``, ``V_MPEG4/ISO/ASP``), ``vp9_small.webm`` (``VP90``),
    ``vp8_small.webm`` (``VP80``) and ``vp9_small.mp4`` (``vp09`` with
    ``vpcC``);
  * with the EBML writer below: ``vp9_live.webm``, ``vp9_small.webm``'s
    packets as a live recorder writes them (an unknown-size Segment and
    unknown-size Clusters, no ``Cues``, no ``Duration``, no
    ``DefaultDuration``); ``mjpeg_laced.mkv``, ``mjpeg_small.mkv``'s
    packets laced two to a block (Xiph, EBML, then fixed lacing, the
    fixed lace's JPEGs padded to one size after their EOI) under header
    stripping (their common first bytes in ``ContentCompSettings``);
    ``h264_opengop.mkv``, 24 frames of x264 with ``open-gop=1`` (an IDR,
    then non-IDR I-frames whose leading B-frames refer across them), 2
    B-frames, in ``BlockGroup``s (``ReferenceBlock`` on every
    non-keyframe);
  * x265's 24-frame stream (3 B-frames, an intra picture every 8 frames,
    open GOP: CRA pictures with RASL leading pictures) in
    ``hevc_small.mp4`` (``hvc1``: the parameter sets in ``hvcC`` only),
    ``hevc_hev1.mp4`` (``hev1``: also in band before each IRAP) and
    ``hevc_small.mkv`` (``V_MPEGH/ISO/HEVC``);
  * libaom's 24-frame stream (good quality, lag 35: hidden alt-ref frames
    shown later through ``show_existing_frame``; a key frame every 12) in
    ``av1_small.mp4`` (``av01``) and ``av1_small.mkv`` (``V_AV1``), the
    temporal delimiters left out as both bindings ask.  cv2's FFmpeg has
    no software AV1 decoder (it reads no AV1 frame), so the reference
    frames are libaom's decoder's (``aom_decode``) of the temporal units
    libaom wrote: the SHA-256 of each shown frame's Y, U and V planes
    (``aom_sha256``);
  * ``containers_ref.json``: for each file, what ``cv2.VideoCapture``
    reads: ``CAP_PROP_FPS``, ``CAP_PROP_FRAME_COUNT``, the size, the
    SHA-256 of each RGB frame read in order (``sha256``) and, for each
    index i, which of those frames ``cap.set(CAP_PROP_POS_FRAMES, i)`` then
    ``cap.read()`` gives (``seek``; -1: a frame not in the sequence).

A rerun rewrites some files with other bytes (FFmpeg's Matroska muxer
draws random UIDs; the open-GOP x264 stream has differed between runs),
and the reference JSON with them: commit the files of one run
together.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import struct
import sys
import tempfile

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from siammot_tpu_torch.data import codecs  # noqa: E402
from siammot_tpu_torch.data.container import (_box,  # noqa: E402
                                              open_video)
from tools.make_torch_video_fixtures import (avcc,  # noqa: E402
                                             cv2_seek, scene, sha256,
                                             write_mp4, x264_encode)
import tools.make_torch_video_fixtures as h264_tool  # noqa: E402

W, H, N, N_CV2, N_MJPEG, FPS = 200, 120, 24, 12, 6, 25


# -- EBML and Matroska --------------------------------------------------------

UNKNOWN = b"\x01\xff\xff\xff\xff\xff\xff\xff"


def ebml_id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def ebml_size(n: int) -> bytes:
    length = 1
    while n >= (1 << (7 * length)) - 1:
        length += 1
    return (n | 1 << (7 * length)).to_bytes(length, "big")


def el(eid: int, *parts: bytes, unknown: bool = False) -> bytes:
    body = b"".join(parts)
    return ebml_id(eid) + (UNKNOWN if unknown else ebml_size(len(body))) \
        + body


def uint_el(eid: int, v: int) -> bytes:
    return el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def float_el(eid: int, v: float) -> bytes:
    return el(eid, struct.pack(">d", v))


def str_el(eid: int, v: str) -> bytes:
    return el(eid, v.encode())


def xiph(n: int) -> bytes:
    return b"\xff" * (n // 255) + bytes([n % 255])


def ebml_signed(v: int) -> bytes:
    """A signed EBML lace size difference."""
    length = 1
    while not -(1 << (7 * length - 1)) + 1 <= v <= (1 << (7 * length - 1)) - 1:
        length += 1
    return ((v + (1 << (7 * length - 1)) - 1) | 1 << (7 * length)) \
        .to_bytes(length, "big")


def lace(frames: list, kind: int) -> tuple:
    """(lacing flag bits, lace header) of ``frames`` laced as ``kind``: 1
    Xiph, 3 EBML, 2 fixed."""
    head = bytes([len(frames) - 1])
    if kind == 1:
        head += b"".join(xiph(len(f)) for f in frames[:-1])
    elif kind == 3:
        head += ebml_size(len(frames[0]))
        head += b"".join(ebml_signed(len(b) - len(a))
                         for a, b in zip(frames, frames[1:-1]))
    return kind << 1, head


def write_mkv(path, codec_id: str, private: bytes, packets: list, *,
              doc_type="matroska", cues=True, duration=True, unknown=False,
              default_duration=True, groups=False, laced=0, strip=b"",
              roll=None, per_cluster=8, zlib=False, audio=False):
    """A one-track Matroska file of ``packets`` (dicts: ``data``, ``pts`` in
    frames, ``key``), in decode order, stamped in ms.  ``unknown``: the
    Segment and Clusters of unknown size; ``groups``: BlockGroups (a
    ReferenceBlock on each non-keyframe) instead of SimpleBlocks;
    ``default_duration``: True (25 fps), False (none) or nanoseconds;
    ``laced``: that many frames a block, cycling Xiph, EBML and fixed
    lacing; ``strip``: header stripping's bytes, cut off each frame;
    ``roll``: ``ProjectionPoseRoll``; ``zlib``: a zlib ContentEncoding
    (the frames left as they are: a reader must refuse it); ``audio``: a
    PCM track listed first (track 2), a block of it before each video
    block."""
    step = 1000 / FPS
    video = [uint_el(0xB0, W), uint_el(0xBA, H)]
    if roll is not None:
        video.append(el(0x7670, uint_el(0x7671, 0), float_el(0x7675, roll)))
    entry = [uint_el(0xD7, 1), uint_el(0x73C5, 1), uint_el(0x83, 1),
             str_el(0x86, codec_id)]
    if laced:
        entry.append(uint_el(0x9C, 1))
    if private:
        entry.append(el(0x63A2, private))
    if default_duration:
        entry.append(uint_el(0x23E383, int(round(1e9 / FPS))
                             if default_duration is True
                             else default_duration))
    entry.append(el(0xE0, *video))
    if strip or zlib:
        comp = [uint_el(0x4254, 0 if zlib else 3)]
        if strip:
            comp.append(el(0x4255, strip))
        entry.append(el(0x6D80, el(0x6240, uint_el(0x5031, 0),
                                   uint_el(0x5032, 1), uint_el(0x5033, 0),
                                   el(0x5034, *comp))))
    info = [uint_el(0x2AD7B1, 1000000), str_el(0x4D80, "siammot fixtures"),
            str_el(0x5741, "siammot fixtures")]
    if duration:
        info.append(float_el(0x4489, len(packets) * step))
    tracks = [el(0xAE, *entry)]
    if audio:
        tracks.insert(0, el(0xAE, uint_el(0xD7, 2), uint_el(0x73C5, 2),
                            uint_el(0x83, 2), str_el(0x86, "A_PCM/INT/LIT"),
                            el(0xE1, float_el(0xB5, 8000.0),
                               uint_el(0x9F, 1), uint_el(0x6264, 16))))
    head = el(0x1549A966, *info) + el(0x1654AE6B, *tracks)
    clusters, points, pos = [], [], len(head)
    for c in range(0, len(packets), per_cluster):
        group = packets[c:c + per_cluster]
        base = int(round(min(p["pts"] for p in group) * step))
        blocks = [uint_el(0xE7, base)]
        for b in range(0, len(group), laced or 1):
            frames = group[b:b + (laced or 1)]
            first = frames[0]
            rel = int(round(first["pts"] * step)) - base
            datas = [f["data"][len(strip):] for f in frames]
            flags, lace_head = 0, b""
            if laced:
                kind = (1, 3, 2)[(b // laced) % 3]
                if kind == 2:
                    size = max(map(len, datas))
                    datas = [d + bytes(size - len(d)) for d in datas]
                if len(datas) > 1:
                    flags, lace_head = lace(datas, kind)
            if audio:
                blocks.append(el(0xA3, b"\x82" + struct.pack(">hB", rel, 0x80)
                                 + bytes(640)))
            block = ebml_size(1) + struct.pack(">h", rel) + lace_head
            if groups:
                body = [el(0xA1, block[:3] + bytes([flags]) + block[3:]
                           + b"".join(datas))]
                if not first["key"]:
                    body.append(el(0xFB, struct.pack(">b", -1)))
                blocks.append(el(0xA0, *body))
            else:
                flags |= 0x80 if first["key"] else 0
                blocks.append(el(0xA3, block[:3] + bytes([flags]) + block[3:]
                                 + b"".join(datas)))
            if first["key"] and (not points or points[-1][1] != pos):
                points.append((base + rel, pos))
        cluster = el(0x1F43B675, *blocks, unknown=unknown)
        clusters.append(cluster)
        pos += len(cluster)
    body = head + b"".join(clusters)
    if cues:
        body += el(0x1C53BB6B, *(el(0xBB, uint_el(0xB3, t), el(
            0xB7, uint_el(0xF7, 1), uint_el(0xF1, at))) for t, at in points))
    ebml = el(0x1A45DFA3, uint_el(0x4286, 1), uint_el(0x42F7, 1),
              uint_el(0x42F2, 4), uint_el(0x42F3, 8), str_el(0x4282, doc_type),
              uint_el(0x4287, 4), uint_el(0x4285, 2))
    with open(path, "wb") as f:
        f.write(ebml + el(0x18538067, body, unknown=unknown))


# -- MP4 ----------------------------------------------------------------------

def visual_entry(kind: bytes, *config: bytes) -> bytes:
    return _box(kind, bytes(6), struct.pack(">H", 1), bytes(16),
                struct.pack(">HHIIIH", W, H, 0x480000, 0x480000, 0, 1),
                bytes(32), struct.pack(">Hh", 24, -1), *config)


# -- x265 through ctypes ------------------------------------------------------

X265_OPTS = {"input-res": f"{W}x{H}", "fps": str(FPS), "bframes": "3",
             "keyint": "8", "min-keyint": "8", "scenecut": "0",
             "open-gop": "1", "repeat-headers": "1", "annexb": "1",
             "frame-threads": "1", "pools": "none", "info": "0",
             "crf": "30", "log-level": "error"}


_vp, _i, _s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
X265_API = {"param_alloc": ("x265_param_alloc", _vp),
            "param_free": ("x265_param_free", None, _vp),
            "param_parse": ("x265_param_parse", _i, _vp, _s, _s),
            "param_default_preset": ("x265_param_default_preset", _i, _vp,
                                     _s, _s),
            "picture_alloc": ("x265_picture_alloc", _vp),
            "picture_free": ("x265_picture_free", None, _vp),
            "picture_init": ("x265_picture_init", None, _vp, _vp),
            "encoder_open": ("x265_encoder_open_199", _vp, _vp),
            "encoder_encode": ("x265_encoder_encode", _i, _vp,
                               ctypes.POINTER(_vp),
                               ctypes.POINTER(ctypes.c_uint32), _vp, _vp),
            "encoder_close": ("x265_encoder_close", None, _vp)}


def x265_api(depth: int) -> dict:
    """The functions of libx265's build for ``depth`` bits (8, 10 or 12),
    from ``x265_api_get_199(depth)``'s table: each entry's place in the
    table is where the 8-bit table holds the exported symbol of that
    name."""
    lib = ctypes.CDLL("libx265.so.199")
    vp = ctypes.c_void_p
    lib.x265_api_get_199.restype = vp
    lib.x265_api_get_199.argtypes = [ctypes.c_int]
    base, table = lib.x265_api_get_199(8), lib.x265_api_get_199(depth)
    if not table:
        raise RuntimeError(f"libx265.so.199 has no {depth}-bit build")
    words = struct.unpack("<40Q", ctypes.string_at(base + 48, 320))
    out = {}
    for key, (name, *sig) in X265_API.items():
        at = 48 + 8 * words.index(ctypes.cast(getattr(lib, name), vp).value)
        ptr, = struct.unpack("<Q", ctypes.string_at(table + at, 8))
        out[key] = ctypes.CFUNCTYPE(*sig)(ptr)
    return out


def x265_encode(frames) -> list:
    """RGB frames -> packets in decode order (:func:`x265_encode_planes`
    of their 8-bit I420 planes with ``X265_OPTS``)."""
    planes = []
    for rgb in frames:
        i420 = cv2.cvtColor(np.ascontiguousarray(rgb),
                            cv2.COLOR_RGB2YUV_I420)
        planes.append([i420[:H], i420[H:H + H // 4].reshape(H // 2, W // 2),
                       i420[H + H // 4:].reshape(H // 2, W // 2)])
    return x265_encode_planes(planes, X265_OPTS)[0]


def x265_encode_planes(planes, opts: dict, depth: int = 8) -> tuple:
    """Y, U, V planes (one triple a frame; 4:2:0 or, with ``opts``'
    ``input-csp`` i444, 4:4:4) -> (packets in decode order, the encoder's
    reconstruction of each frame in display order).  A packet is a dict:
    ``data``, Annex B with the parameter sets in band before each IRAP;
    ``pts``; ``dts``; ``key``.  At ``depth`` > 8 the planes are 16-bit
    words holding ``depth``-bit samples (libx265's ``depth``-bit build).
    ``x265_picture`` (build 199): ``pts`` at byte 0, ``dts`` at 8,
    ``planes`` at 24, ``stride`` at 48 (bytes); ``x265_nal``: type, size,
    payload pointer.  The reconstruction is ``pic_out``'s planes."""
    x = x265_api(depth)
    vp = ctypes.c_void_p
    dtype = np.uint8 if depth == 8 else np.uint16
    param = x["param_alloc"]()
    if x["param_default_preset"](param, b"medium", None):
        raise RuntimeError("x265_param_default_preset failed")
    for k, v in opts.items():
        if x["param_parse"](param, k.encode(), v.encode()):
            raise RuntimeError(f"x265 refuses {k}={v}")
    enc = x["encoder_open"](param)
    if not enc:
        raise RuntimeError("x265_encoder_open failed")
    pic_in, pic_out = x["picture_alloc"](), x["picture_alloc"]()
    x["picture_init"](param, pic_in)
    x["picture_init"](param, pic_out)
    nals, count = vp(), ctypes.c_uint32()
    packets, recon = [], {}
    shapes = [p.shape for p in planes[0]]

    def take(got):
        if got > 0:
            table = ctypes.string_at(nals.value, 16 * count.value)
            data = b""
            for i in range(count.value):
                _, size, ptr = struct.unpack_from("<IIQ", table, 16 * i)
                data += ctypes.string_at(ptr, size)
            head = ctypes.string_at(pic_out, 64)
            pts, dts = struct.unpack_from("<qq", head)
            frame = []
            for (ph, pw), ptr, stride in zip(
                    shapes, struct.unpack_from("<3Q", head, 24),
                    struct.unpack_from("<3i", head, 48)):
                rows = np.frombuffer(ctypes.string_at(ptr, stride * ph),
                                     dtype).reshape(ph, -1)
                frame.append(np.ascontiguousarray(rows[:, :pw]))
            recon[pts] = frame
            key = any(16 <= codecs.nal_type(codecs.HEVC, u) <= 23
                      for u in codecs.nal_units(data, 0))
            packets.append(dict(data=data, pts=pts, dts=dts, key=key))

    keep = []
    try:
        for t, frame in enumerate(planes):
            frame = [np.ascontiguousarray(p, dtype) for p in frame]
            keep.append(frame)
            buf = bytearray(ctypes.string_at(pic_in, 64))
            struct.pack_into("<q", buf, 0, t)
            struct.pack_into("<3Q", buf, 24, *(p.ctypes.data for p in frame))
            struct.pack_into("<3i", buf, 48, *(p.strides[0] for p in frame))
            ctypes.memmove(pic_in, bytes(buf), 64)
            take(x["encoder_encode"](enc, ctypes.byref(nals),
                                     ctypes.byref(count), pic_in, pic_out))
        while True:
            got = x["encoder_encode"](enc, ctypes.byref(nals),
                                      ctypes.byref(count), None, pic_out)
            if got <= 0:
                break
            take(got)
    finally:
        del keep
        x["encoder_close"](enc)
        x["picture_free"](pic_in)
        x["picture_free"](pic_out)
        x["param_free"](param)
    return packets, [recon[t] for t in sorted(recon)]


def hvcc_record(units: list, complete: bool, depth: int = 8,
                chroma: int = 1) -> bytes:
    """An ``hvcC`` body (ISO/IEC 14496-15 8.3.3) of a VPS, SPS and PPS:
    the profile, tier and level bytes copied from the SPS, 4-byte NAL
    lengths, ``depth`` bits and ``chroma_format_idc`` ``chroma``."""
    sps = codecs.unescape(next(u for u in units
                               if codecs.nal_type(codecs.HEVC, u) == 33))
    body = bytes([1]) + sps[3:15] + bytes([0xF0, 0, 0xFC, 0xFC | chroma,
                                           0xF8 | depth - 8,
                                           0xF8 | depth - 8, 0, 0, 0x0F, 3])
    for kind in (32, 33, 34):
        unit = next(u for u in units
                    if codecs.nal_type(codecs.HEVC, u) == kind)
        body += bytes([complete << 7 | kind]) + struct.pack(">HH", 1,
                                                            len(unit)) + unit
    return body


def length_prefixed(units: list) -> bytes:
    return b"".join(struct.pack(">I", len(u)) + u for u in units)


# -- libaom through ctypes ----------------------------------------------------

AOM_IMG_FMT_I420, AOM_CODEC_ABI_MISMATCH = 0x102, 3


def aom_encode(frames) -> list:
    """RGB frames -> temporal units in decode order (dicts: ``data``, the
    low-overhead OBUs libaom writes; ``pts``; ``dts``; ``key``).
    ``aom_codec_enc_cfg_t`` (libaom 3.6): ``g_threads`` at byte 4,
    ``g_w``/``g_h`` at 12/16, ``g_timebase`` at 40, ``rc_target_bitrate``
    at 136, ``kf_min_dist``/``kf_max_dist`` at 188/192; a frame packet's
    ``buf``, ``sz`` and ``pts`` at bytes 8, 16 and 24."""
    lib = ctypes.CDLL("libaom.so.3")
    vp = ctypes.c_void_p
    lib.aom_codec_av1_cx.restype = vp
    lib.aom_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
    lib.aom_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.aom_codec_set_option.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
    lib.aom_img_wrap.argtypes = [vp, ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_uint, vp]
    lib.aom_img_wrap.restype = vp
    lib.aom_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong,
                                     ctypes.c_long]
    lib.aom_codec_get_cx_data.argtypes = [vp, ctypes.POINTER(vp)]
    lib.aom_codec_get_cx_data.restype = vp
    lib.aom_codec_destroy.argtypes = [vp]
    lib.aom_img_free.argtypes = [vp]
    iface = lib.aom_codec_av1_cx()
    cfg = ctypes.create_string_buffer(4096)
    if lib.aom_codec_enc_config_default(iface, cfg, 0):
        raise RuntimeError("aom_codec_enc_config_default failed")
    struct.pack_into("<I", cfg, 4, 1)
    struct.pack_into("<II", cfg, 12, W, H)
    struct.pack_into("<ii", cfg, 40, 1, FPS)
    struct.pack_into("<I", cfg, 136, 120)
    struct.pack_into("<II", cfg, 188, 12, 12)
    ctx = ctypes.create_string_buffer(1024)
    for ver in range(64):               # AOM_ENCODER_ABI_VERSION
        rc = lib.aom_codec_enc_init_ver(ctx, iface, cfg, 0, ver)
        if rc != AOM_CODEC_ABI_MISMATCH:
            break
    if rc:
        raise RuntimeError(f"aom_codec_enc_init failed ({rc})")
    for k, v in (("cpu-used", "6"), ("auto-alt-ref", "1")):
        if lib.aom_codec_set_option(ctx, k.encode(), v.encode()):
            raise RuntimeError(f"libaom refuses {k}={v}")
    packets = []

    def drain():
        it = vp()
        while True:
            pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                return
            kind, = struct.unpack_from("<i", ctypes.string_at(pkt, 4))
            if kind != 0:                       # AOM_CODEC_CX_FRAME_PKT
                continue
            buf, size, pts = struct.unpack_from("<QQq", ctypes.string_at(
                pkt + 8, 24))
            data = ctypes.string_at(buf, size)
            packets.append(dict(data=data, pts=pts, dts=len(packets)))

    try:
        for t, rgb in enumerate(frames):
            i420 = np.ascontiguousarray(cv2.cvtColor(
                np.ascontiguousarray(rgb), cv2.COLOR_RGB2YUV_I420))
            img = lib.aom_img_wrap(None, AOM_IMG_FMT_I420, W, H, 1,
                                   i420.ctypes.data)
            rc = lib.aom_codec_encode(ctx, img, t, 1, 0)
            lib.aom_img_free(img)
            if rc:
                raise RuntimeError(f"aom_codec_encode failed on frame {t}")
            drain()
        while True:
            before = len(packets)
            if lib.aom_codec_encode(ctx, None, 0, 0, 0):
                raise RuntimeError("aom_codec_encode failed at the flush")
            drain()
            if len(packets) == before:
                break
    finally:
        lib.aom_codec_destroy(ctx)
    seq = None
    for p in packets:
        units = codecs.obus(p["data"])
        for kind, whole, payload in units:
            if kind == codecs.OBU_SEQUENCE_HEADER:
                seq = seq or (whole, payload)
        p["data"] = b"".join(w for k, w, _ in units
                             if k != codecs.OBU_TEMPORAL_DELIMITER)
        h = codecs.av1_header(p["data"], False)
        p["key"] = h["key"] and h["show"]
    return packets, seq


def av1c_record(seq) -> bytes:
    """An ``av1C`` body (AV1-ISOBMFF 2.3.3) for libaom's 8-bit 4:2:0
    stream: seq_profile and seq_level_idx[0] read from its sequence header
    (no timing or decoder model info, one operating point), then the
    sequence header OBU."""
    whole, payload = seq
    r = codecs.BitReader(payload)
    profile, _, reduced = r.u(3), r.u(1), r.u(1)
    if reduced:
        level, tier = r.u(5), 0
    else:
        if r.u(1) or r.u(1):
            raise RuntimeError("libaom wrote timing or decoder model info")
        r.u(1)                                      # initial display delay
        if r.u(5):
            raise RuntimeError("libaom wrote several operating points")
        r.u(12)
        level = r.u(5)
        tier = r.u(1) if level > 7 else 0
    return bytes([0x81, profile << 5 | level, tier << 7 | 0x0C, 0]) + whole


def aom_decode(units: list) -> list:
    """libaom's decoder over AV1 temporal units (each with its temporal
    delimiter): the shown frames' (Y, U, V) uint8 planes, in order.
    ``aom_codec_dec_cfg_t``: threads, w, h, ``allow_lowbitdepth`` (set:
    8-bit planes); ``aom_image_t`` (libaom 3.6): ``fmt`` at byte 0,
    ``d_w``/``d_h`` at 40/44, the chroma shifts at 56/60, ``planes`` at
    64 and ``stride`` at 88."""
    lib = ctypes.CDLL("libaom.so.3")
    vp = ctypes.c_void_p
    lib.aom_codec_av1_dx.restype = vp
    lib.aom_codec_dec_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.aom_codec_decode.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t,
                                     vp]
    lib.aom_codec_get_frame.argtypes = [vp, ctypes.POINTER(vp)]
    lib.aom_codec_get_frame.restype = vp
    lib.aom_codec_destroy.argtypes = [vp]
    ctx = ctypes.create_string_buffer(1024)
    cfg = ctypes.create_string_buffer(struct.pack("<4I", 1, 0, 0, 1))
    for ver in range(64):               # AOM_DECODER_ABI_VERSION
        rc = lib.aom_codec_dec_init_ver(ctx, lib.aom_codec_av1_dx(), cfg, 0,
                                        ver)
        if rc != AOM_CODEC_ABI_MISMATCH:
            break
    if rc:
        raise RuntimeError(f"aom_codec_dec_init failed ({rc})")
    out = []
    try:
        for unit in units:
            if lib.aom_codec_decode(ctx, unit, len(unit), None):
                raise RuntimeError("aom_codec_decode failed")
            it = vp()
            while True:
                img = lib.aom_codec_get_frame(ctx, ctypes.byref(it))
                if not img:
                    break
                head = ctypes.string_at(img, 100)
                fmt, = struct.unpack_from("<i", head, 0)
                w, h = struct.unpack_from("<II", head, 40)
                sx, sy = struct.unpack_from("<II", head, 56)
                ptrs = struct.unpack_from("<3Q", head, 64)
                strides = struct.unpack_from("<3i", head, 88)
                if fmt != AOM_IMG_FMT_I420:
                    raise RuntimeError(f"libaom gave image format {fmt:#x}")
                frame = []
                for k, (ptr, stride) in enumerate(zip(ptrs, strides)):
                    pw = w if k == 0 else (w + sx) >> sx
                    ph = h if k == 0 else (h + sy) >> sy
                    rows = np.frombuffer(ctypes.string_at(ptr, stride * ph),
                                         np.uint8).reshape(ph, stride)
                    frame.append(np.ascontiguousarray(rows[:, :pw]))
                out.append(tuple(frame))
    finally:
        lib.aom_codec_destroy(ctx)
    return out


# -- cv2's reading ------------------------------------------------------------

def cv2_read(path) -> dict:
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 cannot open {path}")
    meta = dict(fps=cap.get(cv2.CAP_PROP_FPS),
                count=cap.get(cv2.CAP_PROP_FRAME_COUNT),
                width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(bgr[..., ::-1]))
    cap.release()
    meta["sha256"] = [sha256(f) for f in frames]
    meta["frames"] = len(frames)
    meta["seek"] = [int(i) for i in cv2_seek(path, frames)]
    return meta


def cv2_write(path, fourcc: str, frames) -> None:
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS, (W, H))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc}")
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()


def demuxed(path) -> list:
    """The packets of a file as the port demuxes them (decode order)."""
    v = open_video(path)
    rank = v.rank()
    return [dict(data=d, pts=rank[i], key=i in v.sync)
            for i, d in enumerate(v.packets())]


def common_prefix(packets) -> bytes:
    first = packets[0]["data"]
    n = min(len(p["data"]) for p in packets)
    k = 0
    while k < n and all(p["data"][k] == first[k] for p in packets):
        k += 1
    return first[:min(k, 64)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures", "video"))
    args = ap.parse_args()
    out = args.out
    os.makedirs(out, exist_ok=True)
    cv2.setNumThreads(2)

    def at(name):
        return os.path.join(out, name)

    frames = scene(W, H, N)
    names = []
    for name, fourcc in (("mjpeg_small.mkv", "MJPG"),
                         ("mpeg4_small.mkv", "XVID"),
                         ("vp9_small.webm", "VP90"),
                         ("vp8_small.webm", "VP80"),
                         ("vp9_small.mp4", "vp09")):
        cv2_write(at(name), fourcc,
                  frames[:N_MJPEG if fourcc == "MJPG" else N_CV2])
        names.append(name)
    write_mkv(at("vp9_live.webm"), "V_VP9", b"", demuxed(at("vp9_small.webm")),
              doc_type="webm", cues=False, duration=False, unknown=True,
              default_duration=False)
    mjpeg = demuxed(at("mjpeg_small.mkv"))
    write_mkv(at("mjpeg_laced.mkv"), "V_MJPEG", b"", mjpeg, laced=2,
              strip=common_prefix(mjpeg))
    names += ["vp9_live.webm", "mjpeg_laced.mkv"]

    with tempfile.TemporaryDirectory() as tmp:
        h264_tool.X264_OPTS["open-gop"] = "1"
        headers, packets = x264_encode(frames, W, H,
                                       os.path.join(tmp, "og.yuv"))
    units = codecs.nal_units(b"".join(headers), 0)
    sps = next(u for u in units if u[0] & 0x1F == 7)
    pps = next(u for u in units if u[0] & 0x1F == 8)
    write_mkv(at("h264_opengop.mkv"), "V_MPEG4/ISO/AVC", avcc(sps, pps)[8:], [
        dict(p, data=length_prefixed([u for u in codecs.nal_units(
            p["data"], 0) if u[0] & 0x1F not in (7, 8)]))
        for p in packets], groups=True)
    names.append("h264_opengop.mkv")

    hevc = x265_encode(frames)
    units = codecs.nal_units(hevc[0]["data"], 0)
    params = (32, 33, 34)
    in_band = [dict(p, data=length_prefixed(codecs.nal_units(p["data"], 0)))
               for p in hevc]
    out_of_band = [dict(p, data=length_prefixed(
        [u for u in codecs.nal_units(p["data"], 0)
         if codecs.nal_type(codecs.HEVC, u) not in params])) for p in hevc]
    write_mp4(at("hevc_small.mp4"), visual_entry(
        b"hvc1", _box(b"hvcC", hvcc_record(units, True))), out_of_band, W, H)
    write_mp4(at("hevc_hev1.mp4"), visual_entry(
        b"hev1", _box(b"hvcC", hvcc_record(units, False))), in_band, W, H)
    write_mkv(at("hevc_small.mkv"), "V_MPEGH/ISO/HEVC",
              hvcc_record(units, True), out_of_band)
    names += ["hevc_small.mp4", "hevc_hev1.mp4", "hevc_small.mkv"]

    av1, seq = aom_encode(frames)
    config = av1c_record(seq)
    shown = sorted({p["pts"] for p in av1})
    if len(av1) != N or shown != list(range(N)):
        raise RuntimeError(f"libaom gave {len(av1)} temporal units, pts "
                           f"{shown}")
    write_mp4(at("av1_small.mp4"), visual_entry(
        b"av01", _box(b"av1C", config)), av1, W, H)
    write_mkv(at("av1_small.mkv"), "V_AV1", config, av1)
    names += ["av1_small.mp4", "av1_small.mkv"]

    ref = {name: cv2_read(at(name)) for name in names}
    planes = aom_decode([codecs.av1_temporal_unit(p["data"], b"")
                         for p in av1])
    for name in ("av1_small.mp4", "av1_small.mkv"):
        ref[name]["aom_sha256"] = [[sha256(p) for p in f] for f in planes]
    with open(at("containers_ref.json"), "w") as f:
        json.dump(ref, f, indent=1)
    total = 0
    for name in names + ["containers_ref.json"]:
        size = os.path.getsize(at(name))
        total += size
        meta = ref.get(name, {})
        print(f"{name}: {size} bytes; cv2 {meta.get('frames')} frames, "
              f"count {meta.get('count')}, fps {meta.get('fps')}, seek "
              f"{meta.get('seek')}")
    print(f"total {total} bytes")


if __name__ == "__main__":
    main()
