"""H.264, HEVC, MPEG-4 Part 2, VP8, VP9 and AV1 video on the card:
NVIDIA's hardware decoder (NVDEC), bound with ctypes (``nvdec.cu``, built
with ``nvcc`` at first use by :func:`native._load`), and the conversions
that give the bytes the JAX package gets from ``cv2.VideoCapture``.

A :class:`Session` is one NVDEC parser and decoder on PyTorch's primary
context of a CUDA device, working on a CUDA stream of its own.  It takes
an elementary stream a packet at a time (``data/container.py`` makes it
from the file: Annex B H.264 and HEVC, MPEG-4 Part 2 with its VOL
header, VP8 and VP9 frames, AV1 temporal units) and gives back, in
display order, each frame that the packet released: a conversion kernel
reads the mapped surface, the RGB frame is copied to the host, then the
surface is unmapped.  An end of stream releases the frames the decoder
still holds for reordering.

The decoder writes NV12 for 8-bit 4:2:0, P016 for 10- and 12-bit 4:2:0,
YUV444 for 8-bit 4:4:4 and YUV444_16Bit for 10- and 12-bit 4:4:4 (16-bit
words, each sample in the top bits).  :func:`nv12_to_rgb`,
:func:`p016_to_rgb` and :func:`yuv444_to_rgb` are the kernels' wrappers:
on a CUDA tensor or a mapped surface each launches its kernel
(``nvdec.cu``) and counts the launch; on a CPU tensor each takes its plain
version, the same integer arithmetic in PyTorch: swscale's, as cv2 calls it
(BT.601 limited range; NV12 through the x86 route, each 2x2 block sharing
its chroma; P016 and YUV444 through the generic scaler, SWS_BICUBIC, the
4:2:0 chroma filtered by :func:`chroma_filters`; ``nvdec.cu`` writes each
out).

There is no decoder behind NVDEC: a missing ``libnvcuvid.so.1``, a codec
the card's ``cuvidGetDecoderCaps`` does not list at the stream's bit depth
and chroma format (raised naming the codec, depth, chroma and the card), or
a failed build raises, and a CPU device raises (the port has no software
decoder for these codecs).  A stream that is not 8-, 10- or 12-bit 4:2:0
or 4:4:4 raises before a session opens (``container.Video.decodable``).
The ctypes structs below mirror those ``nvdec.cu`` declares by hand (Video
Codec SDK 12.x layouts); the tests hold both to the sizes and offsets of
that SDK.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import native

# cudaVideoCodec
CODEC_IDS = {"MPEG-4 Part 2": 2, "H.264": 4, "HEVC": 8, "VP8": 9, "VP9": 10,
             "AV1": 11}
CHROMA_IDS = {"4:2:0": 1, "4:4:4": 3}                # cudaVideoChromaFormat
# cudaVideoSurfaceFormat: what the decoder writes for each (chroma, depth)
NV12, P016, YUV444, YUV444_16BIT = 0, 1, 2, 3
END_OF_STREAM = 1                # nvd_parse's flag: CUVID_PKT_ENDOFSTREAM


def surface_format(chroma: str, depth: int) -> int:
    """The surface an NVDEC decoder writes for a stream of ``chroma`` and
    ``depth`` bits (``nvdec.cu``'s choice)."""
    if chroma == "4:4:4":
        return YUV444_16BIT if depth > 8 else YUV444
    return P016 if depth > 8 else NV12


# -- the SDK 12.x structs, as nvdec.cu declares them -------------------------

_ul, _ui, _us, _uc = (ctypes.c_ulong, ctypes.c_uint, ctypes.c_ushort,
                      ctypes.c_ubyte)
_vp = ctypes.c_void_p


class Rect16(ctypes.Structure):
    _fields_ = [("left", ctypes.c_short), ("top", ctypes.c_short),
                ("right", ctypes.c_short), ("bottom", ctypes.c_short)]


class DecodeCaps(ctypes.Structure):                 # CUVIDDECODECAPS
    _fields_ = [("eCodecType", ctypes.c_int), ("eChromaFormat", ctypes.c_int),
                ("nBitDepthMinus8", _ui), ("reserved1", _ui * 3),
                ("bIsSupported", _uc), ("nNumNVDECs", _uc),
                ("nOutputFormatMask", _us), ("nMaxWidth", _ui),
                ("nMaxHeight", _ui), ("nMaxMBCount", _ui),
                ("nMinWidth", _us), ("nMinHeight", _us),
                ("bIsHistogramSupported", _uc), ("nCounterBitDepth", _uc),
                ("nMaxHistogramBins", _us), ("reserved3", _ui * 10)]


class DecodeCreateInfo(ctypes.Structure):           # CUVIDDECODECREATEINFO
    _fields_ = [("ulWidth", _ul), ("ulHeight", _ul),
                ("ulNumDecodeSurfaces", _ul), ("CodecType", ctypes.c_int),
                ("ChromaFormat", ctypes.c_int), ("ulCreationFlags", _ul),
                ("bitDepthMinus8", _ul), ("ulIntraDecodeOnly", _ul),
                ("ulMaxWidth", _ul), ("ulMaxHeight", _ul),
                ("Reserved1", _ul), ("display_area", Rect16),
                ("OutputFormat", ctypes.c_int),
                ("DeinterlaceMode", ctypes.c_int), ("ulTargetWidth", _ul),
                ("ulTargetHeight", _ul), ("ulNumOutputSurfaces", _ul),
                ("vidLock", _vp), ("target_rect", Rect16),
                ("enableHistogram", _ul), ("Reserved2", _ul * 4)]


class ProcParams(ctypes.Structure):                 # CUVIDPROCPARAMS
    _fields_ = [("progressive_frame", ctypes.c_int),
                ("second_field", ctypes.c_int),
                ("top_field_first", ctypes.c_int),
                ("unpaired_field", ctypes.c_int), ("reserved_flags", _ui),
                ("reserved_zero", _ui), ("raw_input_dptr", ctypes.c_ulonglong),
                ("raw_input_pitch", _ui), ("raw_input_format", _ui),
                ("raw_output_dptr", ctypes.c_ulonglong),
                ("raw_output_pitch", _ui), ("Reserved1", _ui),
                ("output_stream", _vp), ("Reserved", _ui * 46),
                ("histogram_dptr", _vp), ("Reserved2", _vp * 1)]


class VideoFormat(ctypes.Structure):                # CUVIDEOFORMAT
    _fields_ = [("codec", ctypes.c_int), ("frame_rate", _ui * 2),
                ("progressive_sequence", _uc),
                ("bit_depth_luma_minus8", _uc),
                ("bit_depth_chroma_minus8", _uc),
                ("min_num_decode_surfaces", _uc), ("coded_width", _ui),
                ("coded_height", _ui), ("display_area", ctypes.c_int * 4),
                ("chroma_format", ctypes.c_int), ("bitrate", _ui),
                ("display_aspect_ratio", ctypes.c_int * 2),
                ("video_signal_description", _uc * 4),
                ("seqhdr_data_length", _ui)]


class ParserDispInfo(ctypes.Structure):             # CUVIDPARSERDISPINFO
    _fields_ = [("picture_index", ctypes.c_int),
                ("progressive_frame", ctypes.c_int),
                ("top_field_first", ctypes.c_int),
                ("repeat_first_field", ctypes.c_int),
                ("timestamp", ctypes.c_longlong)]


class ParserParams(ctypes.Structure):               # CUVIDPARSERPARAMS
    _fields_ = [("CodecType", ctypes.c_int), ("ulMaxNumDecodeSurfaces", _ui),
                ("ulClockRate", _ui), ("ulErrorThreshold", _ui),
                ("ulMaxDisplayDelay", _ui), ("flags", _ui),
                ("uReserved1", _ui * 4), ("pUserData", _vp),
                ("pfnSequenceCallback", _vp), ("pfnDecodePicture", _vp),
                ("pfnDisplayPicture", _vp), ("pfnGetOperatingPoint", _vp),
                ("pfnGetSEIMsg", _vp), ("pvReserved2", _vp * 5),
                ("pExtVideoInfo", _vp)]


class SourceDataPacket(ctypes.Structure):           # CUVIDSOURCEDATAPACKET
    _fields_ = [("flags", _ul), ("payload_size", _ul), ("payload", _vp),
                ("timestamp", ctypes.c_longlong)]


STRUCTS = (DecodeCaps, DecodeCreateInfo, ProcParams, VideoFormat,
           ParserDispInfo, ParserParams, SourceDataPacket)


# -- the library --------------------------------------------------------------

@functools.cache
def library() -> ctypes.CDLL:
    """``nvdec.cu``, built with ``nvcc`` at first use and loaded (the
    conversion kernel needs no more; :func:`load_decoder` opens NVDEC)."""
    i, p, u8p = ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
    lib = native._declare(native._load(
        "nvdec", "nvdec.cu", ["-ldl"],
        "nvcc (the CUDA toolkit; set CUDA_HOME)"), [
        ("nvd_error", [], ctypes.c_char_p),
        ("nvd_cuda_error_string", [i], ctypes.c_char_p),
        ("nvd_load", [], i),
        ("nvd_caps", [i, i, i, i, ctypes.POINTER(_ui)], i),
        ("nvd_create", [i, i, ctypes.POINTER(p)], i),
        ("nvd_destroy", [p], None),
        ("nvd_parse", [p, u8p, ctypes.c_size_t, i, p], i),
        ("nvd_ready", [p], i),
        ("nvd_front", [p, ctypes.POINTER(ctypes.c_ulonglong),
                       ctypes.POINTER(_ui), ctypes.POINTER(i),
                       ctypes.POINTER(i), ctypes.POINTER(i),
                       ctypes.POINTER(i), ctypes.POINTER(i)], i),
        ("nvd_release", [p], i),
        ("nvd_nv12_to_rgb", [p, p, i, i, i, p, p], i),
        ("nvd_p016_to_rgb", [p, p, i, i, i, i, p, p, i, p, p, i, p, p], i),
        ("nvd_yuv444_to_rgb", [p, p, i, i, i, i, p, p], i)])
    return lib


def load_decoder() -> None:
    """Open NVIDIA's ``libnvcuvid.so.1`` (and ``libcuda.so.1``);
    raises, naming the library, where it is missing.  Sessions and
    :func:`decoder_caps` open it themselves."""
    lib = library()
    _check(lib, lib.nvd_load(), "loading libnvcuvid.so.1 and libcuda.so.1")


class NvdecError(RuntimeError):
    """A failed NVDEC call.  ``code`` is the driver's ``CUresult`` where the
    driver answered (2: ``CUDA_ERROR_OUT_OF_MEMORY``), -1 where the port's
    own step failed (a library or symbol missing, a bad stream)."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise NvdecError(f"NVDEC: {what}: {lib.nvd_error().decode()}", rc)


def _cuda_check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.nvd_cuda_error_string(rc).decode()} ({rc})")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"NVDEC runs on a CUDA device, not {device}")
    return torch.device("cuda", device.index if device.index is not None
                        else torch.cuda.current_device())


def decoder_caps(codec: str, device, depth: int = 8,
                 chroma: str = "4:2:0") -> dict:
    """``cuvidGetDecoderCaps`` for ``codec`` at ``depth`` bits and
    ``chroma`` (4:2:0 or 4:4:4) on ``device``."""
    device = _device(device)
    lib = library()
    out = (_ui * 8)()
    _check(lib, lib.nvd_caps(device.index, CODEC_IDS[codec],
                             CHROMA_IDS[chroma], depth, out),
           f"cuvidGetDecoderCaps for {depth}-bit {chroma} {codec}")
    keys = ("supported", "nvdecs", "output_format_mask", "max_width",
            "max_height", "max_macroblocks", "min_width", "min_height")
    return dict(zip(keys, (int(v) for v in out)))


# -- the conversions ----------------------------------------------------------

class Surface(NamedTuple):
    """A mapped NVDEC frame: device addresses of its luma and chroma rows,
    their pitch in bytes, and the display size.  ``chroma`` is the
    interleaved CbCr plane of an NV12 or P016 surface, or the Cb plane of a
    YUV444 one (its Cr plane follows after :func:`chroma_row` rows)."""
    luma: int
    chroma: int
    pitch: int
    width: int
    height: int
    device: torch.device


def chroma_row(height: int) -> int:
    """The row where an NVDEC frame's chroma starts (and, in a YUV444
    frame, where its Cr plane starts after the Cb plane): the luma rows
    rounded up to even."""
    return (height + 1) & ~1


def nv12_rows(height: int) -> int:
    """Rows of an NV12 or P016 frame: luma, then half as many chroma."""
    return chroma_row(height) + (height + 1) // 2


def yuv444_rows(height: int) -> int:
    """Rows of a YUV444 frame: the Y, Cb and Cr planes, one under the
    other."""
    return 2 * chroma_row(height) + height


def _ints(t: torch.Tensor) -> torch.Tensor:
    """A surface's 8- or 16-bit words as int32 (16-bit ones unsigned)."""
    if t.dtype == torch.uint8:
        return t.to(torch.int32)
    if t.dtype not in (torch.int16, torch.uint16):
        raise ValueError(f"a surface is uint8 or 16-bit words, not {t.dtype}")
    return t.to(torch.int32) & 0xFFFF


def nv12_to_rgb_plain(nv12: torch.Tensor, width: int,
                      height: int) -> torch.Tensor:
    """An NV12 frame (uint8 [rows, >= width]: ``height`` luma rows, then
    from :func:`chroma_row` the interleaved U, V rows) -> uint8 [height,
    width, 3] RGB with swscale's x86 YUV 4:2:0 arithmetic (``nvdec.cu``)."""
    y = nv12[:height, :width].to(torch.int32)
    c0 = chroma_row(height)
    cw = (width + 1) // 2
    uv = nv12[c0:c0 + (height + 1) // 2, :2 * cw].to(torch.int32) \
        .reshape(-1, cw, 2)
    uv = uv.repeat_interleave(2, 0)[:height].repeat_interleave(2, 1)[:, :width]
    u = 8 * uv[..., 0] - 1024
    v = 8 * uv[..., 1] - 1024
    yy = ((8 * y - 128) * 9539) >> 16
    rgb = torch.stack([yy + ((v * 13075) >> 16),
                       yy + ((u * -3209) >> 16) + ((v * -6660) >> 16),
                       yy + ((u * 16525) >> 16)], -1)
    return rgb.clamp(0, 255).to(torch.uint8)


# Where FFmpeg's decoders place a 4:2:0 stream's chroma for swscale, in its
# src_h_chr_pos / src_v_chr_pos units (1/256 of a luma sample from the
# top-left luma sample): HEVC without VUI chroma_loc_info reports MPEG-2's
# left siting; VP9 and AV1 report none, which swscale takes as centred.
SITING_LEFT, SITING_CENTER = (0, 128), (128, 128)
CHROMA_SITING = {"HEVC": SITING_LEFT, "VP9": SITING_CENTER,
                 "AV1": SITING_CENTER}


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _local_pos(subsample: int, pos: int) -> int:
    """swscale's get_local_pos: a chroma position relative to the ideal
    left (top) edge, in the plane's own 1/256 units."""
    if pos == -1 or pos <= -513:
        pos = (128 << subsample) - 128
    return (pos + 128) >> subsample


def bicubic_filter(src: int, dst: int, src_pos: int, dst_pos: int,
                   align: int, one: int) -> tuple:
    """swscale's ``initFilter`` for SWS_BICUBIC (B 0, C 0.6) at a scale of
    1 or up (``src`` <= ``dst``): (first source index, int32 [dst, taps]
    coefficients summing to ``one``) of each output sample, the taps
    trimmed of near-zero ends, padded to ``align`` and folded into the
    plane at its edges, as swscale builds them; the same size at the same
    position is the identity."""
    inc = ((src << 16) + (dst >> 1)) // dst
    if inc > 1 << 16:
        raise ValueError("bicubic_filter scales up only")
    fone = 1 << 54
    if abs(inc - 0x10000) < 10 and src_pos == dst_pos:
        size, rows, first = 1, [[fone] for _ in range(dst)], list(range(dst))
    else:
        size = max(min(5, src - 2), 1)
        c = int(0.6 * (1 << 24))
        at = ((dst_pos * inc) >> 7) - ((src_pos * 0x10000) >> 7)
        rows, first = [], []
        for _ in range(dst):
            xx = _cdiv(at - (size - 2) * (1 << 16), 1 << 17)
            first.append(xx)
            row = []
            for _ in range(size):
                d = abs(xx * (1 << 17) - at) << 13
                if d >= 1 << 31:
                    coeff = 0
                else:
                    dd = (d * d) >> 30
                    ddd = (dd * d) >> 30
                    if d < 1 << 30:
                        coeff = (12 * (1 << 24) - 6 * c) * ddd \
                            + (-18 * (1 << 24) + 6 * c) * dd \
                            + 6 * (1 << 24) * (1 << 30)
                    else:
                        coeff = -6 * c * ddd + 30 * c * dd - 48 * c * d \
                            + 24 * c * (1 << 30)
                row.append(coeff)
                xx += 1
            rows.append(row)
            at += 2 * inc
    full = size
    keep = 0
    cutoff = 0.002 * fone                       # SWS_MAX_REDUCE_CUTOFF
    for i in range(dst - 1, -1, -1):
        row, cut = rows[i], 0
        for _ in range(full):                   # near zeros off the left
            cut += abs(row[0])
            if cut > cutoff or (i < dst - 1 and first[i] >= first[i + 1]):
                break
            row[:] = row[1:] + [0]
            first[i] += 1
        n, cut = full, 0
        for j in range(full - 1, 0, -1):        # and counted on the right
            cut += abs(row[j])
            if cut > cutoff:
                break
            n -= 1
        keep = max(keep, n)
    if keep == 1 and align == 2:
        align = 1
    size = (keep + align - 1) & ~(align - 1)
    rows = [[r[j] if j < full else 0 for j in range(size)] for r in rows]
    for i, row in enumerate(rows):              # fold into the plane
        if first[i] < 0:
            for j in range(1, size):
                left = max(j + first[i], 0)
                row[left] += row[j]
                row[j] = 0
            first[i] = 0
        if first[i] + size > src:
            shift = first[i] + min(size - src, 0)
            acc = 0
            for j in range(size - 1, -1, -1):
                if first[i] + j >= src:
                    acc += row[j]
                    row[j] = 0
            for j in range(size - 1, -1, -1):
                row[j] = 0 if j < shift else row[j - shift]
            first[i] -= shift
            row[src - 1 - first[i]] += acc
    out = np.zeros((dst, size), np.int32)
    for i, row in enumerate(rows):              # normalise, carrying error
        total = max((sum(row) + one // 2) // one, 1)
        err = 0
        for j in range(size):
            v = row[j] + err
            q = _cdiv(v + (total >> 1) if v >= 0 else v - (total >> 1),
                      total)
            out[i, j] = q
            err = v - q * total
    return np.asarray(first, np.int32), out


@functools.lru_cache(maxsize=16)
def chroma_filters(width: int, height: int, siting: tuple) -> tuple:
    """The filters swscale scales a 4:2:0 frame's chroma with on its way
    to packed RGB (an even ``width``): horizontally, the ``width`` / 2
    chroma columns to as many, each shared by a pair of pixels (the
    identity where the chroma is centred, a bicubic shift where it is
    left-sited); vertically, the chroma rows up to ``height`` by the
    bicubic filter.  (hpos, hcoef, vpos, vcoef) as numpy int32, the
    coefficients in 1/16384 and 1/4096."""
    cw, ch = width // 2, (height + 1) // 2
    hpos, hcoef = bicubic_filter(cw, cw, _local_pos(1, siting[0]),
                                 _local_pos(1, -513), 4, 1 << 14)
    vpos, vcoef = bicubic_filter(ch, height, _local_pos(1, siting[1]),
                                 _local_pos(0, -513), 2, 1 << 12)
    return hpos, hcoef, vpos, vcoef


def _check_shape(width: int, height: int, what: str) -> None:
    if height < 9:
        raise NotImplementedError(
            f"{what}: a 4:2:0 frame {height} rows high: swscale scales fewer "
            f"than 5 chroma rows with a shorter filter and other arithmetic, "
            f"which the port's P016 conversion does not do")
    if width % 2:
        raise NotImplementedError(
            f"{what}: a 4:2:0 frame {width} pixels wide: swscale converts "
            f"odd widths with each pixel's own chroma (SWS_FULL_CHR_H_INT), "
            f"which the port's P016 conversion does not do")


def _ytab(i: torch.Tensor) -> torch.Tensor:
    """swscale's 8-bit luma table for BT.601 limited range: entry i."""
    return ((-65284608 + i * 76309 + 0x8000) >> 16).clamp(0, 255)


def p016_to_rgb_plain(frame: torch.Tensor, width: int, height: int,
                      depth: int, siting: tuple = SITING_LEFT) -> torch.Tensor:
    """A P016 frame (16-bit words [rows, >= width]: ``height`` luma rows,
    then from :func:`chroma_row` the interleaved Cb, Cr rows; each sample
    in the top ``depth`` bits) -> uint8 [height, width, 3] RGB as swscale
    converts ``yuv420p10le`` / ``yuv420p12le`` to BGR24 (``nvdec.cu``
    writes the arithmetic out), the chroma sited at ``siting``."""
    _check_shape(width, height, "p016_to_rgb")
    hpos, hcoef, vpos, vcoef = (torch.from_numpy(a).long().to(frame.device)
                                for a in chroma_filters(width, height,
                                                        tuple(siting)))
    words = _ints(frame).long() >> (16 - depth)
    sh = depth - 1
    cw, ch = width // 2, (height + 1) // 2
    y15 = (words[:height, :width] << 14 >> sh).clamp(max=32767)
    c0 = chroma_row(height)
    uv = words[c0:c0 + ch, :2 * cw].reshape(ch, cw, 2)
    cols = (hpos[:, None] + torch.arange(hcoef.shape[1],
                                         device=frame.device)).clamp(
        max=cw - 1)
    # hScale16To15: each chroma row, horizontally
    c15 = ((uv[:, cols] * hcoef[None, :, :, None]).sum(2) >> sh) \
        .clamp(max=32767)                               # [ch, cw, 2]
    rows = (vpos[:, None] + torch.arange(vcoef.shape[1],
                                         device=frame.device)).clamp(
        max=ch - 1)
    taps = c15[rows]                                    # [h, taps, cw, 2]
    coef = vcoef[:, :, None, None]
    # rows but the last two: the x86 vertical scaler (pmulhw sums, a
    # rounder of 4, then the 16-bit fixed point of nv12_to_rgb)
    c8 = 4 + ((taps * coef) >> 16).sum(1) - 1024
    c8 = c8.repeat_interleave(2, 1)[:, :width]
    u, v = c8[..., 0], c8[..., 1]
    yy = (((4 + (y15 >> 4)) - 128) * 9539) >> 16
    mmx = torch.stack([yy + ((v * 13075) >> 16),
                       yy + ((u * -3209) >> 16) + ((v * -6660) >> 16),
                       yy + ((u * 16525) >> 16)], -1).clamp(0, 255)
    # the last two rows: the C vertical scaler and swscale's tables
    last = max(height - 2, 0)
    ct = (((1 << 18) + (taps[last:] * coef[last:]).sum(1)) >> 19) \
        .clamp(0, 255).repeat_interleave(2, 1)[:, :width]
    u, v = ct[..., 0], ct[..., 1]
    y1 = ((1 << 18) + y15[last:] * 4096) >> 19
    c = torch.stack([
        _ytab(663 + ((v * 89830) >> 16) + y1),
        _ytab(972 + ((u * -22049) >> 16) + ((v * -45756) >> 16) + y1),
        _ytab(617 + ((u * 113537) >> 16) + y1)], -1)
    return torch.cat([mmx[:last], c]).to(torch.uint8)


def yuv444_to_rgb_plain(frame: torch.Tensor, width: int, height: int,
                        depth: int) -> torch.Tensor:
    """A YUV444 frame (uint8 at 8 bits, else 16-bit words with each sample
    in the top ``depth`` bits, [rows, >= width]: the Y, Cb and Cr planes
    from rows 0, :func:`chroma_row` and twice it) -> uint8 [height, width,
    3] RGB as swscale converts ``yuv444p`` / ``yuv444p10le`` /
    ``yuv444p12le`` to BGR24 (``nvdec.cu``)."""
    bits = 8 if frame.dtype == torch.uint8 else 16
    words = _ints(frame).long() >> (bits - depth)
    c0 = chroma_row(height)
    y, u, v = (words[k * c0:k * c0 + height, :width] << (15 - depth)
               for k in range(3))
    yy = (y * 4 - 8192) * 9539 + (1 << 21)
    u = (u - (128 << 7)) * 4
    v = (v - (128 << 7)) * 4
    rgb = torch.stack([yy + v * 13075, yy + v * -6660 + u * -3209,
                       yy + u * 16525], -1)
    # swscale sums in unsigned 32-bit words: a bright Y with a high U or V
    # wraps past 2^31 and comes out 0
    rgb = ((rgb + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return (rgb >> 22).clamp(0, 255).to(torch.uint8)


def _plane_args(frame, width, height, rows, dtypes, what):
    """(luma address, chroma address, pitch, width, height, device) of a
    Surface or a CUDA tensor laid out as the plain version reads it."""
    if isinstance(frame, Surface):
        return (frame.luma, frame.chroma, frame.pitch, frame.width,
                frame.height, frame.device)
    if frame.dtype not in dtypes or frame.dim() != 2 \
            or frame.stride(1) != 1 or frame.shape[1] < width \
            or frame.shape[0] < rows(height) or width < 1 or height < 1:
        raise ValueError(f"{what}: a frame of {width}x{height} is "
                         f"{'/'.join(map(str, dtypes))} [>= {rows(height)}, "
                         f">= {width}] with unit column stride, not "
                         f"{frame.dtype} {tuple(frame.shape)} strides "
                         f"{frame.stride()}")
    pitch = frame.stride(0) * frame.element_size()
    luma = frame.data_ptr()
    return (luma, luma + chroma_row(height) * pitch, pitch, width, height,
            frame.device)


def _launch(fn, what, device, *args) -> torch.Tensor:
    width, height = args[3], args[4]
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    lib = library()
    _cuda_check(lib, getattr(lib, fn)(
        *args, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream), what)
    return out


def nv12_to_rgb(frame, width: int = None, height: int = None) -> torch.Tensor:
    """NV12 -> uint8 [height, width, 3] RGB.  ``frame`` is a :class:`Surface`
    or a uint8 tensor laid out as :func:`nv12_to_rgb_plain` reads it (rows
    of ``frame.stride(0)`` bytes).  A surface or a CUDA tensor launches
    ``nv12_to_rgb_kernel`` on the current stream; a CPU tensor takes
    :func:`nv12_to_rgb_plain`."""
    if not isinstance(frame, Surface) and frame.device.type == "cpu":
        return nv12_to_rgb_plain(frame, width, height)
    luma, chroma, pitch, width, height, device = _plane_args(
        frame, width, height, nv12_rows, (torch.uint8,), "nv12_to_rgb")
    out = _launch("nvd_nv12_to_rgb", "nv12_to_rgb", device, luma, chroma,
                  pitch, width, height)
    nv12_to_rgb.launches += 1
    return out


nv12_to_rgb.launches = 0


@functools.lru_cache(maxsize=16)
def _device_filters(width: int, height: int, siting: tuple,
                    device: torch.device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in chroma_filters(width, height, siting))


def p016_to_rgb(frame, width: int = None, height: int = None,
                depth: int = 10, siting: tuple = SITING_LEFT) -> torch.Tensor:
    """P016 (10- or 12-bit 4:2:0, each sample in the top ``depth`` bits of
    a 16-bit word) -> uint8 [height, width, 3] RGB.  ``frame`` is a
    :class:`Surface` or 16-bit words laid out as :func:`p016_to_rgb_plain`
    reads them.  A surface or a CUDA tensor launches ``p016_to_rgb_kernel``
    on the current stream; a CPU tensor takes :func:`p016_to_rgb_plain`."""
    siting = tuple(siting)
    if not isinstance(frame, Surface) and frame.device.type == "cpu":
        return p016_to_rgb_plain(frame, width, height, depth, siting)
    luma, chroma, pitch, width, height, device = _plane_args(
        frame, width, height, nv12_rows, (torch.int16, torch.uint16),
        "p016_to_rgb")
    _check_shape(width, height, "p016_to_rgb")
    if depth not in (10, 12):
        raise ValueError(f"p016_to_rgb: a depth of 10 or 12, not {depth}")
    hpos, hcoef, vpos, vcoef = _device_filters(width, height, siting,
                                               device)
    out = _launch("nvd_p016_to_rgb", "p016_to_rgb", device, luma, chroma,
                  pitch, width, height, depth, hpos.data_ptr(),
                  hcoef.data_ptr(), hcoef.shape[1], vpos.data_ptr(),
                  vcoef.data_ptr(), vcoef.shape[1])
    p016_to_rgb.launches += 1
    return out


p016_to_rgb.launches = 0


def yuv444_to_rgb(frame, width: int = None, height: int = None,
                  depth: int = 8) -> torch.Tensor:
    """YUV444 (8-bit bytes, or 10- or 12-bit samples in the top bits of
    16-bit words) -> uint8 [height, width, 3] RGB.  ``frame`` is a
    :class:`Surface` (its words 16-bit where ``depth`` > 8) or a tensor
    laid out as :func:`yuv444_to_rgb_plain` reads it.  A surface or a CUDA
    tensor launches ``yuv444_to_rgb_kernel`` on the current stream; a CPU
    tensor takes :func:`yuv444_to_rgb_plain`."""
    if not isinstance(frame, Surface) and frame.device.type == "cpu":
        return yuv444_to_rgb_plain(frame, width, height, depth)
    if depth not in (8, 10, 12):
        raise ValueError(f"yuv444_to_rgb: a depth of 8, 10 or 12, not "
                         f"{depth}")
    dtypes = (torch.uint8,) if depth == 8 else (torch.int16, torch.uint16)
    luma, chroma, pitch, width, height, device = _plane_args(
        frame, width, height, yuv444_rows, dtypes, "yuv444_to_rgb")
    out = _launch("nvd_yuv444_to_rgb", "yuv444_to_rgb", device, luma,
                  chroma, pitch, width, height, depth)
    yuv444_to_rgb.launches += 1
    return out


yuv444_to_rgb.launches = 0


# -- a decoding session -------------------------------------------------------

class Session:
    """One NVDEC parser and decoder for ``codec`` on ``device``.
    :meth:`feed` takes a packet of the elementary stream (None: the end of
    the stream) and returns the frames it released, in display order, as
    host uint8 [h, w, 3] RGB."""

    def __init__(self, codec: str, device, what: str = "a video",
                 depth: int = 8, chroma: str = "4:2:0"):
        self.device = _device(device)
        self.codec = codec
        self.what = what
        self._lib = library()
        caps = decoder_caps(codec, self.device, depth, chroma)
        surface = surface_format(chroma, depth)
        if not caps["supported"] \
                or not caps["output_format_mask"] >> surface & 1:
            raise NotImplementedError(
                f"{what}: the NVDEC of this card "
                f"({torch.cuda.get_device_name(self.device)}) does not decode "
                f"{depth}-bit {chroma} {codec} to surface format {surface} "
                f"(cuvidGetDecoderCaps: {caps})")
        self.stream = torch.cuda.Stream(self.device)
        self._handle = None
        handle = ctypes.c_void_p()
        _check(self._lib, self._lib.nvd_create(
            self.device.index, CODEC_IDS[codec], ctypes.byref(handle)),
            f"{what}: creating the {codec} parser")
        self._handle = handle

    def feed(self, packet) -> list:
        data = packet or b""
        with torch.cuda.stream(self.stream):
            _check(self._lib, self._lib.nvd_parse(
                self._handle, data, len(data),
                END_OF_STREAM if packet is None else 0,
                self.stream.cuda_stream), f"{self.what} ({self.codec})")
            frames = []
            while self._lib.nvd_ready(self._handle):
                frames.append(self._take())
            return frames

    def _take(self) -> np.ndarray:
        ptr, pitch = ctypes.c_ulonglong(), _ui()
        w, h, row = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        fmt, depth = ctypes.c_int(), ctypes.c_int()
        _check(self._lib, self._lib.nvd_front(
            self._handle, ctypes.byref(ptr), ctypes.byref(pitch),
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(row),
            ctypes.byref(fmt), ctypes.byref(depth)), self.what)
        surface = Surface(ptr.value, ptr.value + row.value * pitch.value,
                          pitch.value, w.value, h.value, self.device)
        if fmt.value == NV12:
            rgb = nv12_to_rgb(surface)
        elif fmt.value == P016:
            rgb = p016_to_rgb(surface, depth=depth.value,
                              siting=CHROMA_SITING[self.codec])
        else:
            rgb = yuv444_to_rgb(surface, depth=depth.value)
        host = rgb.cpu().numpy()            # waits for the stream
        _check(self._lib, self._lib.nvd_release(self._handle), self.what)
        return host

    def close(self) -> None:
        if self._handle:
            with torch.cuda.device(self.device):
                self._lib.nvd_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
