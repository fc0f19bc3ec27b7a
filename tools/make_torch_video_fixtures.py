"""Write the video fixtures of the port's H.264 and MPEG-4 Part 2 readers
into ``tests/fixtures/video/``.

    python tools/make_torch_video_fixtures.py [--out DIR]

Needs ``cv2`` and x264's shared library (``libx264.so.164``, bound here
with ctypes; no header is read).  The frames are ``siammot_tpu_torch/
utils/synth.py``'s sprite scene.  It writes:

  * ``h264_small.mp4`` and ``h264_small.avi``: one 200x120, 24-frame H.264
    stream (High profile, CABAC, 2 B-frames with B-pyramid, an IDR every
    8 frames, one thread, 25 fps), in an MP4 as FFmpeg's mov muxer writes
    one (``avcC`` with the parameter sets, length-prefixed NAL units,
    ``stss``, ``ctts`` and an ``elst`` whose media time is the first
    frame's composition offset) and in an AVI as Annex B (fourcc ``H264``,
    parameter sets in band, ``idx1`` with ``AVIIF_KEYFRAME``);
  * ``h264_small_ref.npz``: x264's reconstruction (``dump-yuv``) of that
    stream, planes ``y`` [24, 120, 200], ``u`` and ``v`` [24, 60, 100], in
    display order; the SHA-256 of each of ``cv2.VideoCapture``'s RGB
    frames of the MP4, read in order (``cv2_sha256``; the frames
    themselves would take 1.5 MB); for each index i, which of those frames
    ``cap.set(CAP_PROP_POS_FRAMES, i)`` then ``cap.read()`` gives
    (``cv2_seek``, as measured here: i itself for every i); the same for
    the AVI (``cv2_seek_avi``) and the frame counts cv2 reports
    (``cv2_count``: MP4, AVI);
  * ``h264_720p.mp4``: 16 frames of the 1280x720 scene, the same encoder
    settings, and ``h264_720p_ref.json``: the SHA-256 of each
    reconstructed frame's Y, U and V planes, in display order;
  * ``mpeg4_small.mp4`` (``mp4v``) and ``mpeg4_small.avi`` (``XVID``),
    written by ``cv2.VideoWriter`` at 200x120 and 12 frames, and
    ``mpeg4_small_ref.npz``: cv2's RGB frames (``rgb``), which are the same
    for both files (the tool checks it).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
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
from siammot_tpu_torch.data.container import (IDENTITY, _box,  # noqa: E402
                                              _full)
from siammot_tpu_torch.utils.synth import render_scene  # noqa: E402

SMALL = (200, 120, 24)           # w, h, frames
LARGE = (1280, 720, 16)
MPEG4_FRAMES = 12
FPS = 25
# FFmpeg's mov muxer doubles a 1/25 time base until the scale reaches
# 10000: 12800 units a second, 512 a frame
TIMESCALE, DELTA = 12800, 512
X264_OPTS = {"bframes": "2", "b-pyramid": "normal", "keyint": "8",
             "threads": "1", "fps": str(FPS), "cabac": "1", "crf": "26"}
X264_CSP_I420 = 2


# -- x264 through ctypes ------------------------------------------------------

class _Nal(ctypes.Structure):
    # x264.h's x264_nal_t (build 164)
    _fields_ = [("i_ref_idc", ctypes.c_int), ("i_type", ctypes.c_int),
                ("b_long_startcode", ctypes.c_int),
                ("i_first_mb", ctypes.c_int), ("i_last_mb", ctypes.c_int),
                ("i_payload", ctypes.c_int),
                ("p_payload", ctypes.POINTER(ctypes.c_uint8)),
                ("i_padding", ctypes.c_int)]


def _x264():
    lib = ctypes.CDLL("libx264.so.164")
    vp, nalpp = ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(_Nal))
    ip = ctypes.POINTER(ctypes.c_int)
    for name, args, res in (
            ("x264_param_default_preset", [vp, ctypes.c_char_p,
                                           ctypes.c_char_p], ctypes.c_int),
            ("x264_param_parse", [vp, ctypes.c_char_p, ctypes.c_char_p],
             ctypes.c_int),
            ("x264_param_apply_profile", [vp, ctypes.c_char_p],
             ctypes.c_int),
            ("x264_encoder_open_164", [vp], vp),
            ("x264_picture_alloc", [vp, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int], ctypes.c_int),
            ("x264_picture_clean", [vp], None),
            ("x264_encoder_headers", [vp, nalpp, ip], ctypes.c_int),
            ("x264_encoder_encode", [vp, nalpp, ip, vp, vp], ctypes.c_int),
            ("x264_encoder_delayed_frames", [vp], ctypes.c_int),
            ("x264_encoder_close", [vp], None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def x264_encode(frames, w, h, dump):
    """RGB frames -> (header NAL units, packets in decode order: dicts of
    ``data`` (Annex B), ``pts``, ``dts``, ``key``); x264 writes its
    reconstruction to ``dump``.  ``x264_param_t``'s ``i_width``,
    ``i_height`` and ``i_csp`` are its 8th to 10th ints (x264.h);
    ``x264_picture_t`` holds ``i_pts`` at byte 16, ``i_dts`` at 24,
    ``b_keyframe`` at 12, ``img.i_stride`` at 48 and ``img.plane`` at 64."""
    lib = _x264()
    param = ctypes.create_string_buffer(8192)
    if lib.x264_param_default_preset(param, b"medium", None):
        raise RuntimeError("x264_param_default_preset failed")
    struct.pack_into("<iii", param, 28, w, h, X264_CSP_I420)
    for k, v in list(X264_OPTS.items()) + [("dump-yuv", dump)]:
        if lib.x264_param_parse(param, k.encode(), v.encode()):
            raise RuntimeError(f"x264 refuses {k}={v}")
    if lib.x264_param_apply_profile(param, b"high"):
        raise RuntimeError("x264 refuses the High profile")
    enc = lib.x264_encoder_open_164(param)
    if not enc:
        raise RuntimeError("x264_encoder_open failed")
    pic_in = ctypes.create_string_buffer(4096)
    pic_out = ctypes.create_string_buffer(4096)
    if lib.x264_picture_alloc(pic_in, X264_CSP_I420, w, h):
        raise RuntimeError("x264_picture_alloc failed")
    nals, n = ctypes.POINTER(_Nal)(), ctypes.c_int()
    lib.x264_encoder_headers(enc, ctypes.byref(nals), ctypes.byref(n))
    headers = [ctypes.string_at(nals[i].p_payload, nals[i].i_payload)
               for i in range(n.value)]
    packets = []

    def take(size):
        if size > 0:
            key, pts, dts = struct.unpack_from("<iqq", pic_out, 12)
            packets.append(dict(data=ctypes.string_at(nals[0].p_payload,
                                                      size),
                                pts=pts, dts=dts, key=bool(key)))

    strides = struct.unpack_from("<3i", pic_in, 48)
    planes = struct.unpack_from("<3Q", pic_in, 64)
    try:
        for t, rgb in enumerate(frames):
            i420 = cv2.cvtColor(np.ascontiguousarray(rgb),
                                cv2.COLOR_RGB2YUV_I420)
            rows = [i420[:h], i420[h:h + h // 4].reshape(h // 2, w // 2),
                    i420[h + h // 4:].reshape(h // 2, w // 2)]
            for base, stride, plane in zip(planes, strides, rows):
                for r in range(plane.shape[0]):
                    ctypes.memmove(base + r * stride, plane[r].tobytes(),
                                   plane.shape[1])
            struct.pack_into("<q", pic_in, 16, t)
            size = lib.x264_encoder_encode(enc, ctypes.byref(nals),
                                           ctypes.byref(n), pic_in, pic_out)
            if size < 0:
                raise RuntimeError(f"x264 failed on frame {t}")
            take(size)
        while lib.x264_encoder_delayed_frames(enc):
            take(lib.x264_encoder_encode(enc, ctypes.byref(nals),
                                         ctypes.byref(n), None, pic_out))
    finally:
        lib.x264_picture_clean(pic_in)
        lib.x264_encoder_close(enc)
    return headers, packets


# -- MP4 (as FFmpeg's mov muxer writes H.264) and AVI -----------------------

def avcc(sps: bytes, pps: bytes) -> bytes:
    """An ``avcC`` record as FFmpeg's ``ff_isom_write_avcc`` writes it: 4-byte
    NAL lengths, one SPS, one PPS, and the High profile's chroma format
    and bit depths."""
    body = bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) \
        + struct.pack(">H", len(sps)) + sps + b"\x01" \
        + struct.pack(">H", len(pps)) + pps
    if sps[1] in (100, 110, 122, 144):
        body += bytes([0xFC | 1, 0xF8, 0xF8, 0])
    return _box(b"avcC", body)


def write_h264_mp4(path, headers, packets, w, h):
    units = codecs.nal_units(b"".join(headers), 0)
    sps = next(u for u in units if u[0] & 0x1F == 7)
    pps = next(u for u in units if u[0] & 0x1F == 8)
    samples = []
    for p in packets:
        nals = [n for n in codecs.nal_units(p["data"], 0)
                if n[0] & 0x1F not in (7, 8)]
        samples.append(dict(p, data=b"".join(struct.pack(">I", len(n)) + n
                                             for n in nals)))
    entry = _box(b"avc1", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                 bytes(32), struct.pack(">Hh", 24, -1), avcc(sps, pps))
    write_mp4(path, entry, samples, w, h, b"isomiso2avc1mp41")


def write_mp4(path, entry: bytes, packets: list, w: int, h: int,
              brands: bytes = b"isomiso2mp41"):
    """One video track of ``packets`` (dicts: ``data``, the sample;
    ``pts``, ``dts`` in frames; ``key``) under the sample entry ``entry``,
    as FFmpeg's mov muxer writes one: ``stss``, ``ctts`` from pts - dts
    (the samples' decode times start at 0) and an ``elst`` whose media
    time is the first sample's composition offset (x264 and x265 give the
    first frame pts 0)."""
    samples = [p["data"] for p in packets]
    ctts = [(p["pts"] - p["dts"]) * DELTA for p in packets]
    media_time = ctts[0]
    n = len(samples)
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), brands)
    mdat_at = len(ftyp)
    offsets, pos = [], mdat_at + 8
    for s in samples:
        offsets.append(pos)
        pos += len(s)
    mdat = struct.pack(">I4s", 8 + sum(map(len, samples)), b"mdat") \
        + b"".join(samples)
    duration = n * DELTA
    movie = duration * 1000 // TIMESCALE
    runs = []
    for c in ctts:
        if runs and runs[-1][1] == c:
            runs[-1][0] += 1
        else:
            runs.append([1, c])
    keys = [i + 1 for i, p in enumerate(packets) if p["key"]]
    stbl = _box(
        b"stbl", _full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
        _full(b"stts", 0, 0, struct.pack(">III", 1, n, DELTA)),
        _full(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys),
                                          *keys)),
        _full(b"ctts", 0, 0, struct.pack(">I", len(runs)),
              b"".join(struct.pack(">II", *r) for r in runs)),
        _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
        _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n,
                                          *map(len, samples))),
        _full(b"stco", 0, 0, struct.pack(f">I{n}I", n, *offsets)))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(
        ">IIIIIH10x", 0, 0, 1000, movie, 0x10000, 0x100), IDENTITY,
        bytes(24), struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 0, 3, struct.pack(
        ">IIIII8xHHHxx", 0, 0, 1, 0, movie, 0, 0, 0), IDENTITY,
        struct.pack(">II", w << 16, h << 16))
    elst = _full(b"elst", 0, 0, struct.pack(">IIiI", 1, movie, media_time,
                                            0x10000))
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, TIMESCALE,
                                            duration, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                 b"VideoHandler\0")
    minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                    _full(b"url ", 0, 1))), stbl)
    trak = _box(b"trak", tkhd, _box(b"edts", elst),
                _box(b"mdia", mdhd, hdlr, minf))
    with open(path, "wb") as f:
        f.write(ftyp + mdat + _box(b"moov", mvhd, trak))


def _chunk(cc: bytes, body: bytes) -> bytes:
    return cc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _list(kind: bytes, *parts: bytes) -> bytes:
    return _chunk(b"LIST", kind + b"".join(parts))


def write_avi(path, packets, keys, w, h, fourcc: bytes):
    """One video stream, ``00dc`` chunks and ``idx1`` (offsets from the
    ``movi`` fourcc, ``AVIIF_KEYFRAME`` = 0x10 on ``keys``)."""
    n, big = len(packets), max(map(len, packets))
    avih = struct.pack("<14I", 1000000 // FPS, 0, 0, 0x10, n, 0, 1, big, w,
                       h, 0, 0, 0, 0)
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0,
                                          1, FPS, 0, n, big, 0xFFFFFFFF, 0,
                                          0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih),
                 _list(b"strl", _chunk(b"strh", strh), _chunk(b"strf", strf)))
    body, index = b"", b""
    for p, key in zip(packets, keys):
        index += struct.pack("<4sIII", b"00dc", 0x10 if key else 0,
                             4 + len(body), len(p))
        body += _chunk(b"00dc", p)
    riff = b"AVI " + hdrl + _list(b"movi", body) + _chunk(b"idx1", index)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


# -- cv2's frames -------------------------------------------------------------

def cv2_frames(path) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(bgr[..., ::-1])
    cap.release()
    return np.stack(out)


def cv2_seek(path, frames) -> np.ndarray:
    """For each index i, the sequential frame that ``cap.set(
    CAP_PROP_POS_FRAMES, i)`` then ``cap.read()`` gives (-1: none)."""
    out = []
    for i in range(len(frames)):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, bgr = cap.read()
        cap.release()
        hits = [j for j, f in enumerate(frames)
                if ok and np.array_equal(f, bgr[..., ::-1])]
        out.append(hits[0] if hits else -1)
    return np.array(out, np.int32)


def cv2_count(path) -> int:
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def read_recon(path, w, h, n):
    rec = np.fromfile(path, np.uint8).reshape(n, w * h * 3 // 2)
    q = w * h // 4
    return (rec[:, :w * h].reshape(n, h, w),
            rec[:, w * h:w * h + q].reshape(n, h // 2, w // 2),
            rec[:, w * h + q:].reshape(n, h // 2, w // 2))


def scene(w, h, n):
    if (w, h) == (1280, 720):
        return [f[0] for f in render_scene(n, h)[0]]
    # the sprites are sized for a 384-row frame: render 640x384, shrink
    big = [f[0] for f in render_scene(n, 384, seed=7, h=384, w=640)[0]]
    return [cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA) for f in big]


def h264_clip(out, name, w, h, n, tmp):
    frames = scene(w, h, n)
    dump = os.path.join(tmp, f"{name}.yuv")
    headers, packets = x264_encode(frames, w, h, dump)
    mp4 = os.path.join(out, f"{name}.mp4")
    write_h264_mp4(mp4, headers, packets, w, h)
    return mp4, headers, packets, read_recon(dump, w, h, n)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures", "video"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        w, h, n = SMALL
        mp4, headers, packets, (y, u, v) = h264_clip(args.out, "h264_small",
                                                     w, h, n, tmp)
        avi = os.path.join(args.out, "h264_small.avi")
        first = b"".join(headers)
        write_avi(avi, [(first if i == 0 else b"") + p["data"]
                        for i, p in enumerate(packets)],
                  [p["key"] for p in packets], w, h, b"H264")
        rgb = cv2_frames(mp4)
        np.savez_compressed(
            os.path.join(args.out, "h264_small_ref.npz"), y=y, u=u, v=v,
            cv2_sha256=np.array([sha256(f) for f in rgb]),
            cv2_seek=cv2_seek(mp4, rgb),
            cv2_seek_avi=cv2_seek(avi, rgb),
            cv2_count=np.array([cv2_count(mp4), cv2_count(avi)], np.int32))
        w, h, n = LARGE
        _, _, _, planes = h264_clip(args.out, "h264_720p", w, h, n, tmp)
        digests = [[sha256(p[i]) for p in planes] for i in range(n)]
        with open(os.path.join(args.out, "h264_720p_ref.json"), "w") as f:
            json.dump({"width": w, "height": h, "frames": n,
                       "planes": ["y", "u", "v"], "sha256": digests}, f,
                      indent=1)
        w, h, _ = SMALL
        frames = scene(w, h, MPEG4_FRAMES)
        ref = {}
        for ext, fourcc in (("mp4", "mp4v"), ("avi", "XVID")):
            path = os.path.join(args.out, f"mpeg4_small.{ext}")
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS,
                                 (w, h))
            if not wr.isOpened():
                raise RuntimeError(f"cv2 cannot write {fourcc}")
            for f in frames:
                wr.write(np.ascontiguousarray(f[..., ::-1]))
            wr.release()
            ref[ext] = cv2_frames(path)
        if not np.array_equal(ref["mp4"], ref["avi"]):
            raise AssertionError("cv2 decodes its mp4v MP4 and its XVID AVI "
                                 "to different frames")
        np.savez_compressed(os.path.join(args.out, "mpeg4_small_ref.npz"),
                            rgb=ref["mp4"])
    for f in sorted(os.listdir(args.out)):
        print(f"{f}: {os.path.getsize(os.path.join(args.out, f))} bytes")


if __name__ == "__main__":
    main()
