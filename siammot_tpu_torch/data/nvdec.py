"""H.264, HEVC, MPEG-4 Part 2, VP8, VP9 and AV1 video on the card:
NVIDIA's hardware decoder (NVDEC), bound with ctypes (``nvdec.cu``, built
with ``nvcc`` at first use by :func:`native._load`), and the NV12-to-RGB
conversion that gives the bytes the JAX package gets from
``cv2.VideoCapture``.

A :class:`Session` is one NVDEC parser and decoder on PyTorch's primary
context of a CUDA device, working on a CUDA stream of its own.  It takes
an elementary stream a packet at a time (``data/container.py`` makes it
from the file: Annex B H.264 and HEVC, MPEG-4 Part 2 with its VOL
header, VP8 and VP9 frames, AV1 temporal units) and gives back, in
display order, each frame that the packet released: the
conversion kernel reads the mapped NV12 surface, the RGB frame is copied to
the host, then the surface is unmapped.  An end of stream releases the
frames the decoder still holds for reordering.

:func:`nv12_to_rgb` is that kernel's wrapper: on a CUDA tensor or a mapped
surface it launches ``nv12_to_rgb_kernel`` (``nvdec.cu``) and counts the
launch; on a CPU tensor it takes :func:`nv12_to_rgb_plain`, the same
integer arithmetic in PyTorch (swscale's x86 route: BT.601 limited range,
chroma shared by each 2x2 block; ``nvdec.cu`` writes it out).

There is no decoder behind NVDEC: a missing ``libnvcuvid.so.1``, a codec
the card's ``cuvidGetDecoderCaps`` does not list at 8-bit 4:2:0 (raised
naming the codec and the card), or a failed build raises, and a CPU
device raises (the port has no software decoder for these codecs).  A
stream that is not 8-bit 4:2:0 raises before a session opens
(``container.Video.decodable``).  The ctypes structs below mirror those
``nvdec.cu`` declares by hand (Video Codec SDK 12.x layouts); the tests
hold both to the sizes and offsets of that SDK.
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
END_OF_STREAM = 1                # nvd_parse's flag: CUVID_PKT_ENDOFSTREAM


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
        ("nvd_caps", [i, i, ctypes.POINTER(_ui)], i),
        ("nvd_create", [i, i, ctypes.POINTER(p)], i),
        ("nvd_destroy", [p], None),
        ("nvd_parse", [p, u8p, ctypes.c_size_t, i, p], i),
        ("nvd_ready", [p], i),
        ("nvd_front", [p, ctypes.POINTER(ctypes.c_ulonglong),
                       ctypes.POINTER(_ui), ctypes.POINTER(i),
                       ctypes.POINTER(i), ctypes.POINTER(i)], i),
        ("nvd_release", [p], i),
        ("nvd_nv12_to_rgb", [p, p, i, i, i, p, p], i)])
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


def decoder_caps(codec: str, device) -> dict:
    """``cuvidGetDecoderCaps`` for 8-bit 4:2:0 ``codec`` on ``device``."""
    device = _device(device)
    lib = library()
    out = (_ui * 8)()
    _check(lib, lib.nvd_caps(device.index, CODEC_IDS[codec], out),
           f"cuvidGetDecoderCaps for {codec}")
    keys = ("supported", "nvdecs", "output_format_mask", "max_width",
            "max_height", "max_macroblocks", "min_width", "min_height")
    return dict(zip(keys, (int(v) for v in out)))


# -- the conversion -----------------------------------------------------------

class Surface(NamedTuple):
    """A mapped NVDEC frame: device addresses of its luma and chroma rows,
    their pitch in bytes, and the display size."""
    luma: int
    chroma: int
    pitch: int
    width: int
    height: int
    device: torch.device


def chroma_row(height: int) -> int:
    """The row where an NV12 frame's chroma starts, as NVDEC lays it out:
    the luma rows rounded up to even."""
    return (height + 1) & ~1


def nv12_rows(height: int) -> int:
    return chroma_row(height) + (height + 1) // 2


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


def nv12_to_rgb(frame, width: int = None, height: int = None) -> torch.Tensor:
    """NV12 -> uint8 [height, width, 3] RGB.  ``frame`` is a :class:`Surface`
    or a uint8 tensor laid out as :func:`nv12_to_rgb_plain` reads it (rows
    of ``frame.stride(0)`` bytes).  A surface or a CUDA tensor launches
    ``nv12_to_rgb_kernel`` on the current stream; a CPU tensor takes
    :func:`nv12_to_rgb_plain`."""
    if isinstance(frame, Surface):
        luma, chroma, pitch = frame.luma, frame.chroma, frame.pitch
        width, height, device = frame.width, frame.height, frame.device
    else:
        if frame.device.type == "cpu":
            return nv12_to_rgb_plain(frame, width, height)
        if frame.dtype != torch.uint8 or frame.dim() != 2 \
                or frame.stride(1) != 1 or frame.shape[1] < width \
                or frame.shape[0] < nv12_rows(height) or width < 1 \
                or height < 1:
            raise ValueError(f"nv12_to_rgb: an NV12 frame of {width}x"
                             f"{height} is uint8 [>= {nv12_rows(height)}, "
                             f">= {width}] with unit column stride, not "
                             f"{frame.dtype} {tuple(frame.shape)} strides "
                             f"{frame.stride()}")
        pitch, device = frame.stride(0), frame.device
        luma = frame.data_ptr()
        chroma = luma + chroma_row(height) * pitch
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    lib = library()
    _cuda_check(lib, lib.nvd_nv12_to_rgb(
        luma, chroma, pitch, width, height, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream), "nv12_to_rgb")
    nv12_to_rgb.launches += 1
    return out


nv12_to_rgb.launches = 0


# -- a decoding session -------------------------------------------------------

class Session:
    """One NVDEC parser and decoder for ``codec`` on ``device``.
    :meth:`feed` takes a packet of the elementary stream (None: the end of
    the stream) and returns the frames it released, in display order, as
    host uint8 [h, w, 3] RGB."""

    def __init__(self, codec: str, device, what: str = "a video"):
        self.device = _device(device)
        self.codec = codec
        self.what = what
        self._lib = library()
        caps = decoder_caps(codec, self.device)
        if not caps["supported"]:
            raise NotImplementedError(
                f"{what}: the NVDEC of this card "
                f"({torch.cuda.get_device_name(self.device)}) does not decode "
                f"{codec} (cuvidGetDecoderCaps at 8-bit 4:2:0: {caps})")
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
        _check(self._lib, self._lib.nvd_front(
            self._handle, ctypes.byref(ptr), ctypes.byref(pitch),
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(row)), self.what)
        surface = Surface(ptr.value, ptr.value + row.value * pitch.value,
                          pitch.value, w.value, h.value, self.device)
        rgb = nv12_to_rgb(surface)
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
