"""The port's JPEG frame readers, bound with ctypes (own copies of
``siammot_tpu.data.native`` and ``csrc/frameio.cpp``, plus an nvJPEG
route for the card).

The route follows the device the model runs on, as the kernels' wrappers
do: :class:`FrameReader` decodes

  * on the CPU with libjpeg (``frameio.cpp``: threaded decode fused with
    the bilinear resize), the JAX package's native path, byte for byte;
  * on the card with nvJPEG from the CUDA toolkit (``nvjpeg.cpp``): the
    file decodes into device memory, comes back to the host and is resized
    there by ``bilinear.cpp``, the same resize arithmetic.  nvJPEG's
    inverse DCT and chroma upsampling are its own, so its bytes may differ
    from libjpeg's by a few units.

Either way the frame leaves as uint8 RGB (``models.siammot.
normalize_images`` normalises it on the device) or normalised float32.

The training augmentation's pixel arithmetic runs here too, on the host
on both routes: ``augment.cpp`` reproduces OpenCV's 8-bit resize, HSV
conversions, ``filter2D``, ``GaussianBlur`` and the float ``warpAffine``
of the motion-blur kernel bit for bit, and the JPEG
round trip follows the route (libjpeg's encoder in ``frameio.cpp`` on the
CPU, nvJPEG's in ``nvjpeg.cpp`` on the card).  :func:`decode_jpeg_bytes`
(a file's or a video packet's bytes) and :func:`encode_jpeg` follow the
route too, and on the card :func:`thread_decoder` gives each thread its
own nvJPEG decoder, so a pool of loader threads decodes at once.  The PNG
unfilter of ``data/png.py`` is built here as well (``png.cpp``).
Each library is built at first use with ``g++`` into
``siammot_tpu_torch/_build/``, beside the CUDA kernels, named by a hash of
its sources, its flags and the host's CPU, so a fresh checkout builds it
on its first call.  There is no decoder behind a route's: a missing
library raises, naming it, and so does a file it cannot read.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import threading

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# the flags of the JAX package's csrc/Makefile, so that both builds of the
# same source on one host give the same bytes
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native"]
DECODERS = {"cpu": "libjpeg", "cuda": "nvJPEG"}


def _host_cpu() -> str:
    """The CPU the ``-march=native`` code is for (a build copied to
    another host must not be loaded there)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
    except OSError:
        lines = []
    return platform.machine() + "".join(sorted(set(lines)))


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _load(name: str, src: str, link: list, needs: str,
          include: tuple = (), extra: tuple = ()) -> ctypes.CDLL:
    """Build ``src`` into ``_build/{name}-{hash}.so`` unless it is there,
    then load it.  ``needs`` names what a failed build lacks; ``extra``
    are flags of this library alone."""
    with open(os.path.join(_DIR, src), "rb") as f:
        h = hashlib.sha256(f.read())
    flags = CXX_FLAGS + list(extra) + [f"-I{d}" for d in include]
    h.update(" ".join(flags + link).encode())
    h.update(_host_cpu().encode())
    path = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"the port's {needs} reader needs a C++ "
                               f"compiler (g++) to build {src}")
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [cxx, *flags, os.path.join(_DIR, src), "-o", tmp, "-shared",
               *link]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {src} failed: {needs} (its headers "
                               f"and library) is missing or broken; the port "
                               f"has no other decoder on this route.\n"
                               + " ".join(cmd) + "\n" + res.stdout
                               + res.stderr)
        os.replace(tmp, path)       # atomic: concurrent builds race
    return ctypes.CDLL(path)


_c_int, _c_char_p, _size_t = ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _declare(lib, table) -> ctypes.CDLL:
    for fn, args, res in table:
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    return lib


@functools.cache
def libjpeg_library() -> ctypes.CDLL:
    """``frameio.cpp`` against libjpeg: the CPU route."""
    return _declare(_load("frameio", "frameio.cpp", ["-ljpeg", "-lpthread"],
                          "libjpeg (jpeglib.h, libjpeg.so)"), [
        ("fio_image_size", [_c_char_p, ctypes.POINTER(_c_int),
                            ctypes.POINTER(_c_int)], _c_int),
        ("fio_decode_file", [_c_char_p, _c_int, _c_int, _f32p, _f32p, _f32p],
         _c_int),
        ("fio_decode_file_u8", [_c_char_p, _c_int, _c_int, _u8p], _c_int),
        ("fio_jpeg_roundtrip_u8", [_u8p, _c_int, _c_int, _c_int, _u8p],
         _c_int),
        ("fio_mem_size", [_c_char_p, _size_t, ctypes.POINTER(_c_int),
                          ctypes.POINTER(_c_int)], _c_int),
        ("fio_decode_mem_u8", [_c_char_p, _size_t, _c_int, _c_int, _u8p],
         _c_int),
        ("fio_encode_u8", [_u8p, _c_int, _c_int, _c_int,
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_ulong)], _c_int),
        ("fio_free", [ctypes.c_void_p], None)])


@functools.cache
def bilinear_library() -> ctypes.CDLL:
    """``bilinear.cpp``: the resize alone (no decoder needed)."""
    return _declare(_load("bilinear", "bilinear.cpp", [], "a C++ compiler"), [
        ("fio_resize_u8", [_u8p, _c_int, _c_int, _u8p, _c_int, _c_int],
         None),
        ("fio_resize_normalize", [_u8p, _c_int, _c_int, _f32p, _c_int, _c_int,
                                  _f32p, _f32p], None)])


@functools.cache
def png_library() -> ctypes.CDLL:
    """``png.cpp``: the PNG scanline unfilter (``data/png.py``)."""
    return _declare(_load("png", "png.cpp", [], "a C++ compiler"), [
        ("png_unfilter", [_c_char_p, _c_int, _c_int, _c_int, _u8p], _c_int)])


@functools.cache
def augment_library() -> ctypes.CDLL:
    """``augment.cpp``: OpenCV's 8-bit arithmetic of the training
    augmentation.  Built without contracting a * b + c into fused
    multiply-adds, so the float paths round where the source says."""
    u16p = ctypes.POINTER(ctypes.c_uint16)
    return _declare(_load("augment", "augment.cpp", [], "a C++ compiler",
                          extra=("-ffp-contract=off",)), [
        ("aug_resize_u8", [_u8p, _c_int, _c_int, _u8p, _c_int, _c_int],
         None),
        ("aug_rgb2hsv", [_u8p, _u8p, _size_t], None),
        ("aug_hsv2rgb", [_u8p, _u8p, _c_int, _c_int], None),
        ("aug_filter2d_u8", [_u8p, _c_int, _c_int, _u8p, _f32p, _c_int,
                             _c_int], None),
        ("aug_gauss_u8", [_u8p, _c_int, _c_int, _u8p, u16p, _c_int], None),
        ("aug_warp_f32", [_f32p, _c_int, _c_int,
                          ctypes.POINTER(ctypes.c_double), _f32p], None)])


@functools.cache
def nvjpeg_library() -> ctypes.CDLL:
    """``nvjpeg.cpp`` against the CUDA toolkit's nvJPEG: the card's route."""
    lib_dir = os.path.join(_cuda_home(), "lib64")
    vp = ctypes.c_void_p
    return _declare(_load(
        "nvjpeg", "nvjpeg.cpp", [f"-L{lib_dir}", f"-Wl,-rpath,{lib_dir}",
                                 "-lnvjpeg"],
        "nvJPEG (the CUDA toolkit's nvjpeg.h, libnvjpeg.so; set CUDA_HOME)",
        include=(os.path.join(_cuda_home(), "include"),)), [
        ("nvj_create", [ctypes.POINTER(vp)], _c_int),
        ("nvj_destroy", [vp], None),
        ("nvj_image_size", [vp, _c_char_p, _size_t, ctypes.POINTER(_c_int),
                            ctypes.POINTER(_c_int)], _c_int),
        ("nvj_decode_rgbi", [vp, _c_char_p, _size_t, vp, _c_int, _c_int, vp],
         _c_int),
        ("nvj_encode_rgbi", [vp, vp, _c_int, _c_int, _c_int, vp,
                             ctypes.POINTER(_size_t)], _c_int),
        ("nvj_encoded_bytes", [vp, ctypes.c_char_p, ctypes.POINTER(_size_t),
                               vp], _c_int)])


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check(rc: int, decoder: str, what) -> None:
    if rc != 0:
        raise IOError(f"{decoder} could not decode {what} (error {rc})")


# -- the JPEG header ---------------------------------------------------------

_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


def image_size(path: str) -> tuple:
    """(w, h) of a JPEG from its frame header, read in Python (no decoder
    needed)."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise IOError(f"{path}: not a JPEG file")
        while True:
            b = f.read(1)
            if not b:
                break
            if b != b"\xff":
                continue
            m = f.read(1)
            while m == b"\xff":             # fill bytes
                m = f.read(1)
            if not m:
                break
            marker = m[0]
            if marker == 0x01 or 0xD0 <= marker <= 0xD8:
                continue                    # markers without a segment
            seg = f.read(2)
            if len(seg) < 2:
                break
            length = struct.unpack(">H", seg)[0]
            if marker in _SOF:
                hdr = f.read(5)
                if len(hdr) < 5:
                    break
                h, w = struct.unpack(">HH", hdr[1:5])
                return int(w), int(h)
            f.seek(length - 2, os.SEEK_CUR)
    raise IOError(f"{path}: no JPEG frame header")


# -- the CPU route: libjpeg --------------------------------------------------

def decode_resize(path: str, out_w: int, out_h: int) -> np.ndarray:
    """One JPEG to uint8 [out_h, out_w, 3] RGB with libjpeg (bilinear
    resize; none when the size is the file's)."""
    out = np.empty((out_h, out_w, 3), np.uint8)
    _check(libjpeg_library().fio_decode_file_u8(
        os.fsencode(path), out_w, out_h, _ptr(out, _u8p)), "libjpeg", path)
    return out


def decode_resize_normalize(path: str, out_w: int, out_h: int, mean,
                            std) -> np.ndarray:
    """One JPEG to float32 [out_h, out_w, 3] with libjpeg, ((x / 255) -
    mean) / std per RGB channel, resized in float before any rounding."""
    out = np.empty((out_h, out_w, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    _check(libjpeg_library().fio_decode_file(
        os.fsencode(path), out_w, out_h, _ptr(mean, _f32p), _ptr(std, _f32p),
        _ptr(out, _f32p)), "libjpeg", path)
    return out


# -- the resize alone --------------------------------------------------------

def _rgb8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [h, w, 3], got {img.dtype} "
                         f"{img.shape}")
    return np.ascontiguousarray(img)


def resize_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 [h, w, 3] RGB -> [out_h, out_w, 3], libjpeg route's bilinear."""
    src = _rgb8(img)
    out = np.empty((out_h, out_w, 3), np.uint8)
    bilinear_library().fio_resize_u8(_ptr(src, _u8p), src.shape[1],
                                     src.shape[0], _ptr(out, _u8p), out_w,
                                     out_h)
    return out


def resize_normalize(img: np.ndarray, out_w: int, out_h: int, mean,
                     std) -> np.ndarray:
    """uint8 [h, w, 3] RGB -> normalised float32 [out_h, out_w, 3], as
    :func:`decode_resize_normalize` resizes and normalises."""
    src = _rgb8(img)
    out = np.empty((out_h, out_w, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    bilinear_library().fio_resize_normalize(
        _ptr(src, _u8p), src.shape[1], src.shape[0], _ptr(out, _f32p), out_w,
        out_h, _ptr(mean, _f32p), _ptr(std, _f32p))
    return out


# -- the augmentation's arithmetic (OpenCV's, on the host) -------------------

def cv_resize(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 [h, w, 3] -> [out_h, out_w, 3], the bytes of ``cv2.resize(img,
    (out_w, out_h), interpolation=cv2.INTER_LINEAR)``."""
    src = _rgb8(img)
    out = np.empty((out_h, out_w, 3), np.uint8)
    augment_library().aug_resize_u8(_ptr(src, _u8p), src.shape[1],
                                    src.shape[0], _ptr(out, _u8p), out_w,
                                    out_h)
    return out


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` on uint8: hue in [0, 180)."""
    src = _rgb8(img)
    out = np.empty_like(src)
    augment_library().aug_rgb2hsv(_ptr(src, _u8p), _ptr(out, _u8p),
                                  src.size // 3)
    return out


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` on uint8 (hue < 180)."""
    src = _rgb8(img)
    out = np.empty_like(src)
    augment_library().aug_hsv2rgb(_ptr(src, _u8p), _ptr(out, _u8p),
                                  src.shape[1], src.shape[0])
    return out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` on uint8 with a float32 kernel
    (centre anchor, ``BORDER_REFLECT_101``)."""
    src = _rgb8(img)
    k = np.ascontiguousarray(kernel, np.float32)
    out = np.empty_like(src)
    augment_library().aug_filter2d_u8(_ptr(src, _u8p), src.shape[1],
                                      src.shape[0], _ptr(out, _u8p),
                                      _ptr(k, _f32p), k.shape[1], k.shape[0])
    return out


def gaussian_blur(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur`` on uint8 with OpenCV's Q8 taps (``data.
    augmentation.gaussian_taps``) in both directions."""
    src = _rgb8(img)
    t = np.ascontiguousarray(taps, np.uint16)
    out = np.empty_like(src)
    augment_library().aug_gauss_u8(
        _ptr(src, _u8p), src.shape[1], src.shape[0], _ptr(out, _u8p),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), len(t))
    return out


def warp_affine(img: np.ndarray, m) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h))`` of a float32 [h, w] image
    (bilinear, zero outside); ``m`` the 2x3 forward map, row-major."""
    src = np.ascontiguousarray(img, np.float32)
    m = np.ascontiguousarray(m, np.float64).reshape(6)
    out = np.empty_like(src)
    augment_library().aug_warp_f32(
        _ptr(src, _f32p), src.shape[1], src.shape[0],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _ptr(out, _f32p))
    return out


def libjpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """uint8 RGB -> JPEG at ``quality`` -> uint8 RGB, with libjpeg (the
    bytes of ``cv2.imdecode(cv2.imencode(".jpg", bgr, quality))``)."""
    src = _rgb8(img)
    out = np.empty_like(src)
    _check(libjpeg_library().fio_jpeg_roundtrip_u8(
        _ptr(src, _u8p), src.shape[1], src.shape[0], int(quality),
        _ptr(out, _u8p)), "libjpeg", f"its JPEG round trip at quality "
                                     f"{quality}")
    return out


def libjpeg_decode_bytes(data: bytes, what) -> np.ndarray:
    """A JPEG held in memory (a video packet) to uint8 [h, w, 3] RGB at its
    own size, with libjpeg (``jpeg_mem_src``): the bytes of
    ``cv2.imdecode``."""
    lib = libjpeg_library()
    w, h = _c_int(), _c_int()
    _check(lib.fio_mem_size(data, len(data), ctypes.byref(w),
                            ctypes.byref(h)), "libjpeg", what)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.fio_decode_mem_u8(data, len(data), w.value, h.value,
                                 _ptr(out, _u8p)), "libjpeg", what)
    return out


def libjpeg_encode(img: np.ndarray, quality: int) -> bytes:
    """uint8 [h, w, 3] RGB -> a JPEG stream at ``quality`` with libjpeg's
    defaults (4:2:0 chroma, the standard Huffman tables), as
    ``cv2.imencode(".jpg", bgr)`` and ``cv2.imwrite`` encode."""
    src = _rgb8(img)
    lib = libjpeg_library()
    buf, n = ctypes.c_void_p(), ctypes.c_ulong()
    _check(lib.fio_encode_u8(_ptr(src, _u8p), src.shape[1], src.shape[0],
                             int(quality), ctypes.byref(buf),
                             ctypes.byref(n)),
           "libjpeg", f"(encoding at quality {quality})")
    try:
        return ctypes.string_at(buf.value, n.value)
    finally:
        lib.fio_free(buf)


# -- the card's route: nvJPEG ------------------------------------------------

class NvJpegDecoder:
    """nvJPEG on one card: a file's bytes to uint8 [h, w, 3] RGB, decoded
    on a stream of its own and copied to the host.  One thread at a time."""

    def __init__(self, device):
        self._lib = nvjpeg_library()
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        handle = ctypes.c_void_p()
        _check(self._lib.nvj_create(ctypes.byref(handle)), "nvJPEG",
               "(creating its handle)")
        self._handle = handle

    def decode(self, path: str) -> np.ndarray:
        with open(path, "rb") as f:
            return self.decode_bytes(f.read(), path)

    def decode_bytes(self, data: bytes, what: str) -> np.ndarray:
        w, h = _c_int(), _c_int()
        _check(self._lib.nvj_image_size(self._handle, data, len(data),
                                         ctypes.byref(w), ctypes.byref(h)),
               "nvJPEG", what)
        with torch.cuda.stream(self.stream):
            out = torch.empty((h.value, w.value, 3), dtype=torch.uint8,
                              device=self.device)
            _check(self._lib.nvj_decode_rgbi(
                self._handle, data, len(data), out.data_ptr(), w.value,
                h.value, self.stream.cuda_stream), "nvJPEG", what)
            return out.cpu().numpy()    # waits for the stream

    def encode(self, img: np.ndarray, quality: int) -> bytes:
        """uint8 [h, w, 3] RGB -> a JPEG stream at ``quality``, 4:2:0."""
        src = _rgb8(img)
        h, w = src.shape[:2]
        what = f"(encoding at quality {quality})"
        n = _size_t()
        with torch.cuda.stream(self.stream):
            dev = torch.from_numpy(src).to(self.device)
            _check(self._lib.nvj_encode_rgbi(
                self._handle, dev.data_ptr(), w, h, int(quality),
                self.stream.cuda_stream, ctypes.byref(n)), "nvJPEG", what)
            self.stream.synchronize()
            buf = ctypes.create_string_buffer(n.value)
            _check(self._lib.nvj_encoded_bytes(
                self._handle, buf, ctypes.byref(n), self.stream.cuda_stream),
                "nvJPEG", what)
        return buf.raw[:n.value]

    def roundtrip(self, img: np.ndarray, quality: int) -> np.ndarray:
        """The augmentation's JPEG compression on the card: encode, then
        decode, both with nvJPEG."""
        return self.decode_bytes(self.encode(img, quality),
                                 f"(its own stream at quality {quality})")

    def close(self) -> None:
        if self._handle:
            self._lib.nvj_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


_threads = threading.local()


def thread_decoder(device) -> NvJpegDecoder:
    """This thread's nvJPEG decoder on ``device`` (a handle and a CUDA
    stream of its own, made at the thread's first call), so loader threads
    decode at once without sharing one."""
    device = torch.device(device)
    decoders = getattr(_threads, "decoders", None)
    if decoders is None:
        decoders = _threads.decoders = {}
    if device not in decoders:
        decoders[device] = NvJpegDecoder(device)
    return decoders[device]


def decode_jpeg_bytes(data: bytes, device="cpu", what="(a JPEG in memory)"
                      ) -> np.ndarray:
    """A JPEG held in memory at its own size as uint8 [h, w, 3] RGB, on
    ``device``'s route: libjpeg on the CPU, this thread's nvJPEG decoder on
    the card."""
    device = torch.device(device)
    if device.type == "cuda":
        return thread_decoder(device).decode_bytes(data, what)
    return libjpeg_decode_bytes(data, what)


def encode_jpeg(img: np.ndarray, quality: int, device="cpu") -> bytes:
    """uint8 [h, w, 3] RGB -> a JPEG stream at ``quality``, 4:2:0, on
    ``device``'s route: libjpeg on the CPU, this thread's nvJPEG encoder on
    the card."""
    device = torch.device(device)
    if device.type == "cuda":
        return thread_decoder(device).encode(img, quality)
    return libjpeg_encode(img, quality)


def jpeg_roundtrip(img: np.ndarray, quality: int, device="cpu") -> np.ndarray:
    """The augmentation's JPEG round trip on ``device``'s route: libjpeg on
    the CPU, this thread's nvJPEG encoder and decoder on the card."""
    device = torch.device(device)
    if device.type == "cuda":
        return thread_decoder(device).roundtrip(img, quality)
    return libjpeg_roundtrip(img, quality)


class FrameReader:
    """JPEG file -> uint8 RGB (``decode``) or normalised float32
    (``decode_normalize``) at (out_w, out_h), on the route of ``device``:
    libjpeg on the CPU, nvJPEG on the card (see the module's text)."""

    def __init__(self, device="cpu"):
        device = torch.device(device)
        self.decoder = DECODERS[device.type]
        if device.type == "cuda":
            self._nv = NvJpegDecoder(device)
            bilinear_library()
        else:
            self._nv = None
            libjpeg_library()

    def decode(self, path: str, out_w: int, out_h: int) -> np.ndarray:
        if self._nv is None:
            return decode_resize(path, out_w, out_h)
        img = self._nv.decode(path)
        if img.shape[:2] == (out_h, out_w):
            return img                  # the resize is the identity there
        return resize_u8(img, out_w, out_h)

    def decode_normalize(self, path: str, out_w: int, out_h: int, mean,
                         std) -> np.ndarray:
        if self._nv is None:
            return decode_resize_normalize(path, out_w, out_h, mean, std)
        return resize_normalize(self._nv.decode(path), out_w, out_h, mean,
                                std)
