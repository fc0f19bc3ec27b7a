"""Build and load the port's CUDA kernels (``*.cu`` beside this file).

Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into one shared library with a
plain C interface, bound with ``ctypes`` (no PyTorch headers: a source
that includes them takes minutes to compile, this takes seconds).  The
library goes to ``siammot_tpu_torch/_build/``, named by a hash of the
sources and flags, and is built at first use, so a fresh checkout builds
it on its first call.  No ``--use_fast_math``: the decode kernel relies
on IEEE division and ``expf`` (a zero extent gives inf, exp(-inf) 0).

Every entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.  A kernel launches on PyTorch's
current stream and does not synchronise.  The kernels take their sizes
as C ``int`` and count elements within a tensor in 32 bits:
:func:`check_extent` refuses, before any launch, a tensor of more than
``INT32_MAX`` elements.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess

import torch

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)),
                         "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]


def _sources() -> list:
    return sorted(os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def _build(srcs: list, path: str) -> None:
    """Compile every ``.cu`` in parallel, then link them into ``path``."""
    tmp = f"{path}.{os.getpid()}.d"
    os.makedirs(tmp, exist_ok=True)
    jobs = []
    for src in (p for p in srcs if p.endswith(".cu")):
        obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    cmd = [_nvcc(), *ARCH, "-shared", "-o", f"{tmp}/lib.so",
           *[obj for _, obj, _ in jobs]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(f"{tmp}/lib.so", path)  # atomic: concurrent builds race
    shutil.rmtree(tmp, ignore_errors=True)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    path = os.path.join(BUILD_DIR,
                        f"libsiammot_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        _build(srcs, path)
    lib = ctypes.CDLL(path)
    lib.siammot_error_string.argtypes = [ctypes.c_int]
    lib.siammot_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def function(name: str, argtypes: tuple):
    """A kernel entry point of the library with its C signature."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        msg = library().siammot_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")


INT32_MAX = 2 ** 31 - 1


def check_extent(name: str, *items) -> None:
    """Each item (a tensor the kernel reads, or the shape of one it
    writes) must hold at most ``INT32_MAX`` elements: past that the
    kernel's 32-bit element counts would wrap.  Raises ``ValueError``
    naming the limit."""
    for t in items:
        n = t.numel() if isinstance(t, torch.Tensor) else math.prod(t)
        if n > INT32_MAX:
            shape = tuple(t.shape) if isinstance(t, torch.Tensor) else t
            raise ValueError(
                f"{name}: a tensor of {n} elements {shape} is past the "
                f"kernel's 32-bit element counts (limit 2**31 - 1 = "
                f"{INT32_MAX}); run fewer streams or slots a call")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
