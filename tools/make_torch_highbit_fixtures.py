"""Write the 10- and 12-bit and 4:4:4 fixtures of the port's video readers
into ``tests/fixtures/video/``.

    python tools/make_torch_highbit_fixtures.py [--out DIR]

Needs ``cv2`` and the encoders' shared libraries, bound with ctypes (no
header is read): x265 (``libx265.so.199``, its 8-, 10- and 12-bit builds
through ``x265_api_get_199``, ``make_torch_container_fixtures.x265_api``)
and libvpx (``libvpx.so.7``, VP9's encoder and decoder).  The clips are
``siammot_tpu_torch/utils/synth.py``'s sprite scene at 200x120, 25 fps,
8 frames, turned into Y'CbCr at the clip's depth (BT.601 limited range,
as swscale reads a stream that signals no colour description):

  * ``hevc_main10.mp4`` (``hvc1``), HEVC Main 10, and ``hevc_main12.mkv``,
    Main 12: 4:2:0, 3 B-frames, an intra picture every 4 frames, open GOP;
  * ``hevc_444_8.mp4`` and ``hevc_444_10.mkv``: HEVC 4:4:4 at 8 and 10
    bits, the same GOP;
  * ``vp9_p2.webm``: VP9 profile 2 (10-bit 4:2:0), a key frame every 4
    frames;
  * ``hevc_sweep_10.hevc`` and ``hevc_sweep_444_12.hevc``: lossless x265
    (Annex B, no container) of :func:`sweep_planes` at 10-bit 4:2:0 and
    12-bit 4:4:4, 256x128, 4 frames: three sweeps of every code value and
    the first again with a quarter of seeded noise, so that cv2's frames of
    them are swscale's conversion of known planes;
  * ``highbit_planes.npz``: each clip's planes as the decoder makes them,
    ``{clip}_y``, ``{clip}_u``, ``{clip}_v`` [frames, rows, cols]
    (uint16 above 8 bits; the members LZMA-compressed, which ``np.load``
    reads): x265's reconstruction (``pic_out``), or the system libvpx
    decoder's frames, never cv2's;
  * ``highbit_ref.json``: for each file, what ``cv2.VideoCapture`` reads
    (``make_torch_container_fixtures.cv2_read``: fps, count, size, the
    SHA-256 of each RGB frame, which is the JAX package's
    ``video_frames``, and the seek list), with ``depth`` and ``chroma``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import struct
import sys
import zipfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from siammot_tpu_torch.data import codecs  # noqa: E402
from siammot_tpu_torch.data.container import _box  # noqa: E402
from tools.make_torch_container_fixtures import (  # noqa: E402
    FPS, H, W, cv2_read, hvcc_record, length_prefixed, visual_entry,
    write_mkv, x265_encode_planes)
from tools.make_torch_video_fixtures import scene, write_mp4  # noqa: E402

N = 8
SWEEP_W, SWEEP_H, SWEEP_N = 256, 128, 4
CLIPS = {                   # name: (codec, depth, 4:4:4)
    "hevc_main10.mp4": ("HEVC", 10, False),
    "hevc_main12.mkv": ("HEVC", 12, False),
    "hevc_444_8.mp4": ("HEVC", 8, True),
    "hevc_444_10.mkv": ("HEVC", 10, True),
    "vp9_p2.webm": ("VP9", 10, False),
}
SWEEPS = {"hevc_sweep_10.hevc": (10, False),
          "hevc_sweep_444_12.hevc": (12, True)}


def clip_key(name: str) -> str:
    return name.replace(".", "_")


def rgb_to_yuv(rgb: np.ndarray, depth: int, full_chroma: bool) -> list:
    """BT.601 limited-range Y, Cb, Cr of an RGB frame at ``depth`` bits,
    the chroma averaged over 2x2 blocks unless ``full_chroma``."""
    f = rgb.astype(np.float64) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) / 1.772
    cr = (r - y) / 1.402
    if not full_chroma:
        cb = cb.reshape(H // 2, 2, W // 2, 2).mean((1, 3))
        cr = cr.reshape(H // 2, 2, W // 2, 2).mean((1, 3))
    s = 1 << (depth - 8)
    top = (1 << depth) - 1
    return [np.clip(np.rint(s * (16 + 219 * y)), 0, top),
            np.clip(np.rint(s * (128 + 224 * cb)), 0, top),
            np.clip(np.rint(s * (128 + 224 * cr)), 0, top)]


def sweep_planes(depth: int, full_chroma: bool) -> list:
    """SWEEP_N frames of 256x128 Y, U, V at ``depth`` bits: frames 0-2
    sweep every code of each plane (luma along the rows and columns, U
    along the columns, V along the rows, each frame shifted); frame 3 is
    frame 0 with its top quarter noise from ``RandomState(26)``."""
    top = 1 << depth
    rows, cols = np.mgrid[0:SWEEP_H, 0:SWEEP_W]
    crow, ccol = (rows, cols) if full_chroma else \
        np.mgrid[0:SWEEP_H // 2, 0:SWEEP_W // 2]
    step = top // (SWEEP_W * SWEEP_H // 8) or 1
    out = []
    for t in range(SWEEP_N - 1):
        y = (rows * SWEEP_W + cols) * step // 8 + t * top // 3
        u = ccol * top // ccol.shape[1] + (crow % 8) * (top // 2048 or 1) \
            + t * top // 5
        v = crow * top // crow.shape[0] + (ccol % 16) * (top // 1024 or 1) \
            + t * top // 7
        out.append([p.astype(np.int64) % top for p in (y, u, v)])
    rng = np.random.RandomState(26)
    noisy = [p.copy() for p in out[0]]
    for p in noisy:
        p[:p.shape[0] // 4] = rng.randint(0, top, p[:p.shape[0] // 4].shape)
    out.append(noisy)
    dtype = np.uint8 if depth == 8 else np.uint16
    return [[p.astype(dtype) for p in f] for f in out]


def x265_opts(w: int, h: int, full_chroma: bool, lossless=False) -> dict:
    opts = {"input-res": f"{w}x{h}", "fps": str(FPS),
            "input-csp": "i444" if full_chroma else "i420",
            "bframes": "3", "keyint": "4", "min-keyint": "4",
            "scenecut": "0", "open-gop": "1", "repeat-headers": "1",
            "annexb": "1", "frame-threads": "1", "pools": "none",
            "info": "0", "crf": "36", "log-level": "error"}
    if lossless:
        opts.update(lossless="1", bframes="0")
    return opts


# -- libvpx through ctypes ----------------------------------------------------

VPX_ABI_MISMATCH, VPX_IMG_FMT_I42016 = 3, 0x902
VPX_CODEC_USE_HIGHBITDEPTH, VP8E_SET_CPUUSED = 0x40000, 13


def _vpx():
    lib = ctypes.CDLL("libvpx.so.7")
    vp = ctypes.c_void_p
    lib.vpx_codec_vp9_cx.restype = vp
    lib.vpx_codec_vp9_dx.restype = vp
    lib.vpx_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
    lib.vpx_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.vpx_codec_dec_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.vpx_img_wrap.argtypes = [vp, ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_uint, vp]
    lib.vpx_img_wrap.restype = vp
    lib.vpx_img_free.argtypes = [vp]
    lib.vpx_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong,
                                     ctypes.c_long, ctypes.c_ulong]
    lib.vpx_codec_get_cx_data.argtypes = [vp, ctypes.POINTER(vp)]
    lib.vpx_codec_get_cx_data.restype = vp
    lib.vpx_codec_decode.argtypes = [vp, ctypes.c_char_p, ctypes.c_uint, vp,
                                     ctypes.c_long]
    lib.vpx_codec_get_frame.argtypes = [vp, ctypes.POINTER(vp)]
    lib.vpx_codec_get_frame.restype = vp
    lib.vpx_codec_destroy.argtypes = [vp]
    lib.vpx_codec_control_.argtypes = [vp, ctypes.c_int, ctypes.c_int]
    return lib


def _vpx_init(init, *args) -> None:
    for ver in range(64):               # VPX_{EN,DE}CODER_ABI_VERSION
        rc = init(*args, ver)
        if rc != VPX_ABI_MISMATCH:
            break
    if rc:
        raise RuntimeError(f"vpx_codec_*_init failed ({rc})")


def vp9_encode(planes: list, depth: int) -> list:
    """10- or 12-bit 4:2:0 planes -> VP9 profile 2 frames in decode order
    (dicts: ``data``, ``pts``, ``dts``, ``key``).  ``vpx_codec_enc_cfg_t``
    (libvpx 1.12): ``g_threads``, ``g_profile``, ``g_w``, ``g_h``,
    ``g_bit_depth``, ``g_input_bit_depth`` and ``g_timebase`` from byte 4,
    ``rc_target_bitrate`` at 112, ``kf_min_dist``/``kf_max_dist`` at
    164/168; a frame packet's ``buf``, ``sz``, ``pts`` at bytes 8, 16, 24
    and its flags at 40."""
    lib = _vpx()
    iface = lib.vpx_codec_vp9_cx()
    cfg = ctypes.create_string_buffer(4096)
    if lib.vpx_codec_enc_config_default(iface, cfg, 0):
        raise RuntimeError("vpx_codec_enc_config_default failed")
    struct.pack_into("<8I", cfg, 4, 1, 2, W, H, depth, depth, 1, FPS)
    struct.pack_into("<I", cfg, 112, 300)
    struct.pack_into("<II", cfg, 164, 4, 4)
    ctx = ctypes.create_string_buffer(1024)
    _vpx_init(lib.vpx_codec_enc_init_ver, ctx, iface, cfg,
              VPX_CODEC_USE_HIGHBITDEPTH)
    packets = []

    def drain():
        it = ctypes.c_void_p()
        while True:
            pkt = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                return
            kind, = struct.unpack_from("<i", ctypes.string_at(pkt, 4))
            if kind != 0:                       # VPX_CODEC_CX_FRAME_PKT
                continue
            buf, size, pts, _, flags = struct.unpack_from(
                "<QQqQI", ctypes.string_at(pkt + 8, 36))
            packets.append(dict(data=ctypes.string_at(buf, size), pts=pts,
                                dts=len(packets), key=bool(flags & 1)))

    try:
        if lib.vpx_codec_control_(ctx, VP8E_SET_CPUUSED, 4):
            raise RuntimeError("libvpx refuses cpu-used 4")
        for t, frame in enumerate(planes):
            buf = np.concatenate([p.astype(np.uint16).ravel() for p in frame])
            img = lib.vpx_img_wrap(None, VPX_IMG_FMT_I42016, W, H, 1,
                                   buf.ctypes.data)
            rc = lib.vpx_codec_encode(ctx, img, t, 1, 0, 0)
            lib.vpx_img_free(img)
            if rc:
                raise RuntimeError(f"vpx_codec_encode failed on frame {t}")
            drain()
        while True:
            before = len(packets)
            if lib.vpx_codec_encode(ctx, None, 0, 0, 0, 0):
                raise RuntimeError("vpx_codec_encode failed at the flush")
            drain()
            if len(packets) == before:
                break
    finally:
        lib.vpx_codec_destroy(ctx)
    return packets


def vp9_decode(packets: list) -> list:
    """The system libvpx decoder over VP9 frames: each shown frame's (Y,
    U, V) uint16 planes.  ``vpx_image_t`` (libvpx 1.12): ``fmt`` at byte 0,
    ``d_w``/``d_h`` at 24/28, the chroma shifts at 40/44, ``planes`` at 48
    and ``stride`` (bytes) at 80."""
    lib = _vpx()
    ctx = ctypes.create_string_buffer(1024)
    _vpx_init(lib.vpx_codec_dec_init_ver, ctx, lib.vpx_codec_vp9_dx(), None,
              0)
    out = []
    try:
        for p in packets:
            if lib.vpx_codec_decode(ctx, p["data"], len(p["data"]), None, 0):
                raise RuntimeError("vpx_codec_decode failed")
            it = ctypes.c_void_p()
            while True:
                img = lib.vpx_codec_get_frame(ctx, ctypes.byref(it))
                if not img:
                    break
                head = ctypes.string_at(img, 96)
                fmt, = struct.unpack_from("<i", head, 0)
                w, h = struct.unpack_from("<II", head, 24)
                sx, sy = struct.unpack_from("<II", head, 40)
                if fmt != VPX_IMG_FMT_I42016:
                    raise RuntimeError(f"libvpx gave image format {fmt:#x}")
                frame = []
                for k, (ptr, stride) in enumerate(zip(
                        struct.unpack_from("<3Q", head, 48),
                        struct.unpack_from("<3i", head, 80))):
                    pw = w if k == 0 else (w + sx) >> sx
                    ph = h if k == 0 else (h + sy) >> sy
                    rows = np.frombuffer(ctypes.string_at(ptr, stride * ph),
                                         np.uint16).reshape(ph, -1)
                    frame.append(np.ascontiguousarray(rows[:, :pw]))
                out.append(frame)
    finally:
        lib.vpx_codec_destroy(ctx)
    return out


# -- the files ----------------------------------------------------------------

def hevc_files(path: str, planes: list, depth: int, full_chroma: bool):
    """An x265 clip of ``planes`` in MP4 (``hvc1``) or Matroska; its
    reconstruction."""
    hevc, recon = x265_encode_planes(planes, x265_opts(W, H, full_chroma),
                                     depth)
    units = codecs.nal_units(hevc[0]["data"], 0)
    record = hvcc_record(units, True, depth, 3 if full_chroma else 1)
    packets = [dict(p, data=length_prefixed(
        [u for u in codecs.nal_units(p["data"], 0)
         if codecs.nal_type(codecs.HEVC, u) not in (32, 33, 34)]))
        for p in hevc]
    if path.endswith(".mp4"):
        write_mp4(path, visual_entry(b"hvc1", _box(b"hvcC", record)),
                  packets, W, H)
    else:
        write_mkv(path, "V_MPEGH/ISO/HEVC", record, packets)
    return recon


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures", "video"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    import cv2
    cv2.setNumThreads(2)

    def at(name):
        return os.path.join(args.out, name)

    frames = scene(W, H, N)
    arrays, ref = {}, {}
    for name, (codec, depth, full) in CLIPS.items():
        dtype = np.uint8 if depth == 8 else np.uint16
        planes = [[p.astype(dtype) for p in rgb_to_yuv(f, depth, full)]
                  for f in frames]
        if codec == "VP9":
            packets = vp9_encode(planes, depth)
            write_mkv(at(name), "V_VP9", b"", packets, doc_type="webm")
            made = vp9_decode(packets)
        else:
            made = hevc_files(at(name), planes, depth, full)
        for k, plane in zip("yuv", zip(*made)):
            arrays[f"{clip_key(name)}_{k}"] = np.stack(plane).astype(dtype)
        ref[name] = dict(cv2_read(at(name)), depth=depth,
                         chroma="4:4:4" if full else "4:2:0")
    for name, (depth, full) in SWEEPS.items():
        planes = sweep_planes(depth, full)
        packets, recon = x265_encode_planes(
            planes, x265_opts(SWEEP_W, SWEEP_H, full, lossless=True), depth)
        for a, b in zip(recon, planes):
            if not all(np.array_equal(p, q) for p, q in zip(a, b)):
                raise RuntimeError(f"{name}: x265 was not lossless")
        with open(at(name), "wb") as f:
            f.write(b"".join(p["data"] for p in packets))
        ref[name] = dict(cv2_read(at(name)), depth=depth,
                         chroma="4:4:4" if full else "4:2:0")
    with zipfile.ZipFile(at("highbit_planes.npz"), "w",
                         zipfile.ZIP_LZMA) as z:
        for key, a in arrays.items():
            with z.open(f"{key}.npy", "w") as f:
                np.lib.format.write_array(f, a)
    with open(at("highbit_ref.json"), "w") as f:
        json.dump(ref, f, indent=1)
    total = 0
    for name in [*CLIPS, *SWEEPS, "highbit_planes.npz", "highbit_ref.json"]:
        size = os.path.getsize(at(name))
        total += size
        meta = ref.get(name, {})
        print(f"{name}: {size} bytes; cv2 {meta.get('frames')} frames, "
              f"seek {meta.get('seek')}")
    print(f"total {total} bytes")


if __name__ == "__main__":
    main()
