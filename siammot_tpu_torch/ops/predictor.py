"""Kernel 3: the masked EMM predictor.

Replaces ``siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas``
(``_predictor_kernel``).  Per live slot: two towers of 3x3 conv (nine
shifted matmuls, f32 accumulation) + bias + GroupNorm(32) with
``var = E[x^2] - E[x]^2`` + ReLU, each cast back to the response dtype;
then cls(2) + centerness(1) on the cls tower and ReLU(reg(4)) on the reg
tower.  Dead slots write zeros (PARITY.md #11).

On the H100 the towers are bound by operations (2 x 9 S^2 C^2
multiply-adds per live slot; 2 x 37.7 M at the main path's 16x16x128).
``cuda/predictor.cu`` runs two launches for any S and C (C a multiple of
the 32 groups): the tower conv into an f32 scratch, then a head pass
that takes the GroupNorm statistics, normalises on load and runs the
heads.  In bf16 the tower conv runs on Hopper's warpgroup MMA
(``cuda/wgmma.cuh``): a block stages its band of 128 positions of the
response once in shared memory, each 3x3 tap reads A there at shifted
row addresses (no im2col buffer), and one producer warp streams the
weight slices through a ring so the block reads each weight once; the
grid of (live slot, tower, 128 channels, band) fills the card at 37
live slots as at 128.  In f32 the tower conv is an FFMA implicit GEMM
(tensor cores would round to TF32).  The bf16 form needs the response
and weights 16-byte aligned (cp.async); the wrapper raises otherwise.

Kernel 8 (:func:`emm_predictor_blocked`) replaces
``siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas_blocked``
(``_predictor_kernel_blocked``), which the JAX package takes when
``SIAMMOT_PREDICTOR_BLOCK`` names a block of B > 1 slots: kernel 3's
function with B slots per program, a block without a live slot writing
zeros and the dead lanes of a live block emitting zeros.  On the card
one block per (B-slot group, tower, 16 output channels) stages its
weight slice once and runs the tower conv of the group's live slots
against it (B x less weight traffic than a per-slot kernel); kernel 3's
head pass then normalises and runs the heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

_NAMES = ("cls_tower_conv.kernel", "cls_tower_conv.bias",
          "cls_tower_gn.scale", "cls_tower_gn.bias",
          "reg_tower_conv.kernel", "reg_tower_conv.bias",
          "reg_tower_gn.scale", "reg_tower_gn.bias",
          "cls.kernel", "cls.bias", "center.kernel", "center.bias",
          "reg.kernel", "reg.bias")
_ARGS = (cuda.P, cuda.P, cuda.P) + (cuda.P,) * 4 + (cuda.I,) * 4 \
    + (cuda.P,)
_BLOCKED_ARGS = (cuda.P, cuda.P, cuda.P) + (cuda.P,) * 4 + (cuda.I,) * 5 \
    + (cuda.P,)
GROUPS = 32
EPS = 1e-5


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


def _outputs(x):
    k, s = x.shape[:2]
    return tuple(torch.empty((k, s, s, n), dtype=torch.float32,
                             device=x.device) for n in (2, 1, 4))


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
    cls, ctr, reg = _outputs(x)
    pre = torch.empty((2, k, s * s, c), dtype=torch.float32, device=x.device)
    ptrs = (cuda.P * len(ps))(*[t.data_ptr() for t in ps])
    fn = cuda.function("siammot_emm_predictor", _ARGS)
    err = fn(cuda.ptr(x), cuda.ptr(valid), ptrs, cuda.ptr(pre),
             cuda.ptr(cls), cuda.ptr(ctr), cuda.ptr(reg), k, s, c, int(bf16),
             cuda.stream(x.device))
    cuda.check("emm_predictor", err)
    emm_predictor.launches += 1
    return cls, ctr, reg


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
    ps = _check(x, valid, params)
    _, s, _, c = x.shape
    if (9 * c * 16 + 4 * 16 * 260) * 4 > 227 * 1024:
        raise ValueError(f"blocked predictor: C = {c} weights do not fit "
                         f"shared memory")
    cls, ctr, reg = _outputs(x)
    pre = torch.empty((2, k, s * s, c), dtype=torch.float32, device=x.device)
    ptrs = (cuda.P * len(ps))(*[t.data_ptr() for t in ps])
    fn = cuda.function("siammot_emm_predictor_blocked", _BLOCKED_ARGS)
    cuda.check("emm_predictor_blocked", fn(
        cuda.ptr(x), cuda.ptr(valid), ptrs, cuda.ptr(pre), cuda.ptr(cls),
        cuda.ptr(ctr), cuda.ptr(reg), k, s, c, block,
        int(x.dtype == torch.bfloat16), cuda.stream(x.device)))
    emm_predictor_blocked.launches += 1
    return cls, ctr, reg


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
