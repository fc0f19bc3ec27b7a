"""Kernels 3 and 8: the masked EMM predictor.

Replaces ``siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas``
(``_predictor_kernel``).  Per live slot: two towers of 3x3 conv (nine
shifted matmuls, f32 accumulation) + bias + GroupNorm(32) with
``var = E[x^2] - E[x]^2`` + ReLU, each cast back to the response dtype;
then cls(2) + centerness(1) on the cls tower and ReLU(reg(4)) on the reg
tower.  Dead slots write zeros (PARITY.md #11).

On the H100 the towers are bound by operations (2 x 9 S^2 C^2
multiply-adds per live slot; 2 x 37.7 M at the main path's 16x16x128).
``cuda/predictor.cu`` runs two launches for any S and C (C a multiple of
the 32 groups).  The tower conv writes conv + bias to an f32 scratch in
16-channel planes and, from its epilogue, each tile's per-group partial
sums for the GroupNorm statistics (in a fixed order: two launches give
the same bits).  In bf16 it runs on Hopper's warpgroup MMA
(``cuda/wgmma.cuh``): a block stages its band of 128 positions of the
response once in shared memory, each 3x3 tap reads A there at shifted
row addresses (no im2col buffer), and one producer warp streams the
weight slices through a ring so the block reads each weight once.  In f32
it is an FFMA implicit GEMM (tensor cores would round to TF32).  The head
pass then runs a block per (slot, tower, band of consecutive positions):
it adds the partials, copies its band's rows of the scratch with a
one-row halo (all planes at once where they fit), normalises, applies
ReLU and rounds each element once, and runs the 3x3 heads from shared
memory (cls and centerness as one head of 3 outputs; f32 sums in bf16,
f64 sums in f32).  A band is 256 positions; :func:`head_plan` chooses
all planes a stage where they fit shared memory, else one.  The
bf16 form needs the response and weights 16-byte aligned (cp.async); the
wrapper raises otherwise.

Kernel 8 (:func:`emm_predictor_blocked`) replaces
``siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas_blocked``
(``_predictor_kernel_blocked``), which the JAX package takes when
``SIAMMOT_PREDICTOR_BLOCK`` names a block of B > 1 slots: kernel 3's
function with B slots per program, a block without a live slot writing
zeros and the dead lanes of a live block emitting zeros.  The blocking
saves the TPU weight loads; on the card the weights stay in L2, so
kernel 8 checks B and launches kernel 3's kernels: a dead slot does no
tower work and its outputs are zeros, so a block of B slots without a
live one emits zeros as the JAX kernel does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda
from .xcorr import _smem_limit

_NAMES = ("cls_tower_conv.kernel", "cls_tower_conv.bias",
          "cls_tower_gn.scale", "cls_tower_gn.bias",
          "reg_tower_conv.kernel", "reg_tower_conv.bias",
          "reg_tower_gn.scale", "reg_tower_gn.bias",
          "cls.kernel", "cls.bias", "center.kernel", "center.bias",
          "reg.kernel", "reg.bias")
_ARGS = (cuda.P,) * 8 + (cuda.I,) * 6 + (cuda.P,)
GROUPS = 32
EPS = 1e-5
# the head pass (cuda/predictor.cu, namespace heads): 256 threads, four
# a position, so 64 positions a pass and four passes a band; the scratch
# in planes of 16 channels, staged all planes or one plane at a time
HEAD_THREADS = 256
HEAD_ITEMS = HEAD_THREADS // 4
HEAD_BAND = 4 * HEAD_ITEMS
HEAD_CHANNELS = 16
# positions x output channels of one tower conv block, by dtype
TOWER_TILE = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}


def head_rows(s: int) -> int:
    """Rows a head band of ``HEAD_BAND`` positions stages: the rows its
    positions can span, and a halo row on each side."""
    return min(s, (HEAD_BAND - 1) // s + 2) + 2


def head_smem(s: int, c: int, planes: int = 1) -> int:
    """Dynamic shared memory of a head block at S = ``s``, C = ``c`` and
    ``planes`` 16-channel planes a stage (``heads::smem_bytes``)."""
    return (planes * head_rows(s) * (s + 2) * HEAD_CHANNELS * 4
            + 9 * c * 16 + 4 * c * 4 + (HEAD_THREADS // 32) * GROUPS * 8
            + 2 * GROUPS * 4)


def head_plan(s: int, c: int, smem_limit: int) -> tuple:
    """(planes a stage, shared-memory bytes) of the head pass over [k, s,
    s, c] maps: every plane in one stage where that
    fits ``smem_limit`` (one round trip a block), else one plane a stage
    (the most blocks an SM).  Raises with the limit where one plane does
    not fit."""
    if head_smem(s, c) > smem_limit:
        raise ValueError(
            f"predictor: a head band of {HEAD_BAND} positions of the "
            f"[{s}, {s}, {c}] map stages {head_smem(s, c)} bytes, past "
            f"the {smem_limit} bytes of shared memory a block may use")
    planes = c // HEAD_CHANNELS
    pps = planes if head_smem(s, c, planes) <= smem_limit else 1
    return pps, head_smem(s, c, pps)


def stat_tiles(s: int, c: int, dtype: torch.dtype) -> int:
    """Tiles of the tower conv (position bands x channel tiles), each
    writing one set of GroupNorm partial sums a slot and tower."""
    tp, tc = TOWER_TILE[dtype]
    return -(-s * s // tp) * -(-c // tc)


def _check(x, valid, params):
    """Shapes, dtypes and layout the kernels take; returns the parameters
    in ``_NAMES`` order."""
    k, s, s2, c = x.shape
    if s != s2 or c % GROUPS or x.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError(f"predictor kernel takes [K, S, S, C] f32 or bf16 "
                         f"with C % {GROUPS} == 0, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if valid.dtype != torch.bool or valid.shape != (k,):
        raise ValueError("predictor: valid must be [K] bool")
    ps = [params[n] for n in _NAMES]
    for t in (x, valid, *ps):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("predictor: inputs must be contiguous, on one "
                             "device")
    for t in ps:
        if t.dtype != x.dtype:
            raise ValueError(f"predictor: parameters must be {x.dtype} like "
                             f"the response, got {t.dtype}")
    return ps


def _launch(x, valid, params, name):
    """Kernels 3 and 8 (``name``, for the error) on CUDA tensors: (cls,
    ctr, reg)."""
    ps = _check(x, valid, params)
    k, s, _, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        if any(t.data_ptr() % 16 for t in (x, *ps)):
            raise ValueError("predictor: the bf16 kernel's cp.async needs "
                             "16-byte aligned response and weights")
        smem = cuda.function("siammot_emm_tower_smem", (cuda.I, cuda.I))
        if smem(s, c) < 0:
            raise ValueError(f"predictor: a band of the [{s}, {s}, {c}] "
                             f"response does not fit shared memory")
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    planes, head_bytes = head_plan(s, c, _smem_limit(dev))
    cls, ctr, reg = (torch.empty((k, s, s, n), dtype=torch.float32,
                                 device=x.device) for n in (2, 1, 4))
    pre = torch.empty((2, k, c // HEAD_CHANNELS, s * s, HEAD_CHANNELS),
                      dtype=torch.float32, device=x.device)
    part = torch.empty((2, k, stat_tiles(s, c, x.dtype), GROUPS, 2),
                       dtype=torch.float32, device=x.device)
    ptrs = (cuda.P * len(ps))(*[t.data_ptr() for t in ps])
    fn = cuda.function("siammot_emm_predictor", _ARGS)
    cuda.check(name, fn(cuda.ptr(x), cuda.ptr(valid), ptrs, cuda.ptr(pre),
                        cuda.ptr(part), cuda.ptr(cls), cuda.ptr(ctr),
                        cuda.ptr(reg), k, s, c, planes, head_bytes,
                        int(bf16), cuda.stream(x.device)))
    return cls, ctr, reg


def emm_predictor(x: torch.Tensor, valid: torch.Tensor,
                  params: dict) -> torch.Tensor:
    """Masked fused predictor over [K, S, S, C] responses (f32 or bf16,
    C a multiple of 32).

    ``params`` maps the names in ``_NAMES`` to tensors: conv kernels HWIO
    [3, 3, Cin, Cout], everything in the response's dtype.  Returns
    (cls [K,S,S,2], center [K,S,S,1], reg [K,S,S,4]) f32.  CUDA tensors
    launch the kernel; CPU tensors take :func:`emm_predictor_plain`.
    """
    if x.device.type == "cpu":
        return emm_predictor_plain(x, valid, params)
    out = _launch(x, valid, params, "emm_predictor")
    emm_predictor.launches += 1
    return out


emm_predictor.launches = 0


def emm_predictor_blocked(x: torch.Tensor, valid: torch.Tensor,
                          params: dict, block: int) -> torch.Tensor:
    """Kernel 8: :func:`emm_predictor` computed ``block`` slots at a time
    (``block`` > 1 divides K); the same outputs.  CUDA tensors launch the
    kernel; CPU tensors take :func:`emm_predictor_blocked_plain`."""
    k = x.shape[0]
    if block < 2 or k % block:
        raise ValueError(f"blocked predictor: block {block} must be > 1 and "
                         f"divide K = {k}")
    if x.device.type == "cpu":
        return emm_predictor_blocked_plain(x, valid, params, block)
    out = _launch(x, valid, params, "emm_predictor_blocked")
    emm_predictor_blocked.launches += 1
    return out


emm_predictor_blocked.launches = 0


def _conv9(xp: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """Nine shifted [S*S, Cin] @ [Cin, Cout] taps over a zero-padded
    [K, S+2, S+2, Cin] f32 map -> [K, S*S, Cout] f32."""
    k, cin = xp.shape[0], xp.shape[-1]
    acc = 0
    for dy in range(3):
        for dx in range(3):
            win = xp[:, dy:dy + s, dx:dx + s, :].reshape(k, s * s, cin)
            acc = acc + win @ w[dy, dx].float()
    return acc


def _group_norm(y, scale, bias):
    """GroupNorm over [K, S*S, C] f32, stats in f32, fast variance."""
    k, n, c = y.shape
    yg = y.reshape(k, n, GROUPS, c // GROUPS)
    mean = yg.mean(dim=(1, 3), keepdim=True)
    var = (yg * yg).mean(dim=(1, 3), keepdim=True) - mean * mean
    out = (yg - mean) * torch.rsqrt(var + EPS)
    return out.reshape(k, n, c) * scale.float() + bias.float()


def emm_predictor_plain(x, valid, params):
    """Plain PyTorch version of the kernel's math (f32 products of the
    response-dtype inputs, f32 sums, tower rounded to the response dtype
    before the heads) over the live slots; dead slots zeroed."""
    live = valid.nonzero()[:, 0]
    outs = _predict_plain(x[live], params)
    k, s = x.shape[:2]
    full = tuple(torch.zeros((k, s, s, n), dtype=torch.float32,
                             device=x.device) for n in (2, 1, 4))
    for f, o in zip(full, outs):
        f[live] = o
    return full


def emm_predictor_blocked_plain(x, valid, params, block):
    """Plain PyTorch version of kernel 8: block by block, a block with no
    live slot gives zeros, a live block :func:`emm_predictor_plain` (its
    dead lanes zeros)."""
    outs = []
    for b0 in range(0, x.shape[0], block):
        outs.append(emm_predictor_plain(x[b0:b0 + block],
                                        valid[b0:b0 + block], params))
    return tuple(torch.cat(o) for o in zip(*outs))


def _predict_plain(x, p):
    """Towers and heads of every slot of ``x`` [N, S, S, C]."""
    k, s, _, c = x.shape

    def pad(t):
        return F.pad(t.float(), (0, 0, 1, 1, 1, 1))

    xp = pad(x)

    def tower(name):
        y = _conv9(xp, p[f"{name}_conv.kernel"], s) \
            + p[f"{name}_conv.bias"].float()
        y = _group_norm(y, p[f"{name}_gn.scale"], p[f"{name}_gn.bias"])
        return pad(torch.relu(y).to(x.dtype).reshape(k, s, s, c))

    cls_x = tower("cls_tower")
    reg_x = tower("reg_tower")
    cls = _conv9(cls_x, p["cls.kernel"], s) + p["cls.bias"].float()
    ctr = _conv9(cls_x, p["center.kernel"], s) + p["center.bias"].float()
    reg = torch.relu(_conv9(reg_x, p["reg.kernel"], s)
                     + p["reg.bias"].float())
    return tuple(t.reshape(k, s, s, n)
                 for t, n in zip((cls, ctr, reg), (2, 1, 4)))
