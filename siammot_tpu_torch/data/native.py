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
          include: tuple = ()) -> ctypes.CDLL:
    """Build ``src`` into ``_build/{name}-{hash}.so`` unless it is there,
    then load it.  ``needs`` names what a failed build lacks."""
    with open(os.path.join(_DIR, src), "rb") as f:
        h = hashlib.sha256(f.read())
    flags = CXX_FLAGS + [f"-I{d}" for d in include]
    h.update(" ".join(flags + link).encode())
    h.update(_host_cpu().encode())
    path = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"the port's {needs} reader needs a C++ "
                               f"compiler (g++) to build {src}")
        tmp = f"{path}.{os.getpid()}.tmp"
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
        ("fio_decode_file_u8", [_c_char_p, _c_int, _c_int, _u8p], _c_int)])


@functools.cache
def bilinear_library() -> ctypes.CDLL:
    """``bilinear.cpp``: the resize alone (no decoder needed)."""
    return _declare(_load("bilinear", "bilinear.cpp", [], "a C++ compiler"), [
        ("fio_resize_u8", [_u8p, _c_int, _c_int, _u8p, _c_int, _c_int],
         None),
        ("fio_resize_normalize", [_u8p, _c_int, _c_int, _f32p, _c_int, _c_int,
                                  _f32p, _f32p], None)])


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
         _c_int)])


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
            data = f.read()
        w, h = _c_int(), _c_int()
        _check(self._lib.nvj_image_size(self._handle, data, len(data),
                                         ctypes.byref(w), ctypes.byref(h)),
               "nvJPEG", path)
        with torch.cuda.stream(self.stream):
            out = torch.empty((h.value, w.value, 3), dtype=torch.uint8,
                              device=self.device)
            _check(self._lib.nvj_decode_rgbi(
                self._handle, data, len(data), out.data_ptr(), w.value,
                h.value, self.stream.cuda_stream), "nvJPEG", path)
            return out.cpu().numpy()    # waits for the stream

    def close(self) -> None:
        if self._handle:
            self._lib.nvj_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


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
