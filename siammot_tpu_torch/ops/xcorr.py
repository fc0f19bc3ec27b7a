"""Kernel 2: masked depthwise cross-correlation.

Replaces ``siammot_tpu/ops/pallas/xcorr.py:xcorr_depthwise_pallas`` with
``valid`` (``_xcorr_kernel_masked``), reached from
``siammot_tpu/ops/xcorr.py:xcorr_depthwise_masked``.  Per live slot,
``[Hs, Ws, C] * [Ht, Wt, C] -> [Ho, Wo, C]`` f32, accumulated i-major;
dead slots write zeros.

On the H100 the op is bound by operations on the CUDA cores (it is
depthwise, so there is no tensor-core form).  The CUDA kernel
(``cuda/xcorr.cu``) stages one slot's search and template tiles of 32
channels in shared memory as f32 and keeps each thread's output row in
registers.
"""

from __future__ import annotations

import torch

from . import cuda

_ARGS = (cuda.P, cuda.P, cuda.I, cuda.P, cuda.P, cuda.I, cuda.I, cuda.I,
         cuda.I, cuda.I, cuda.I, cuda.P)


def xcorr_depthwise_masked(search: torch.Tensor, template: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """[K, Hs, Ws, C] x [K, Ht, Wt, C] -> [K, Ho, Wo, C] f32; slots with
    ``valid`` False give zeros.  CUDA tensors launch the kernel; CPU
    tensors take :func:`xcorr_depthwise_plain`."""
    if search.device.type == "cpu":
        return xcorr_depthwise_plain(search, template, valid)
    k, hs, ws, c = search.shape
    _, ht, wt, _ = template.shape
    if search.dtype not in (torch.bfloat16, torch.float32) \
            or template.dtype != search.dtype or valid.dtype != torch.bool:
        raise TypeError("xcorr: search/template bf16 or f32, valid bool")
    if template.shape[0] != k or template.shape[-1] != c \
            or valid.shape != (k,):
        raise ValueError("xcorr: inconsistent shapes")
    ho, wo = hs - ht + 1, ws - wt + 1
    if not (1 <= ho <= 32 and 1 <= wo <= 32):
        raise ValueError(f"xcorr kernel takes outputs up to 32x32, "
                         f"got {ho}x{wo}")
    for t in (search, template, valid):
        if t.device != search.device or not t.is_contiguous():
            raise ValueError("xcorr: inputs must be contiguous, on one "
                             "device")
    out = torch.empty((k, ho, wo, c), dtype=torch.float32,
                      device=search.device)
    fn = cuda.function("siammot_xcorr_masked", _ARGS)
    cuda.check("xcorr", fn(
        cuda.ptr(search), cuda.ptr(template),
        int(search.dtype == torch.bfloat16), cuda.ptr(valid), cuda.ptr(out),
        k, hs, ws, ht, wt, c, cuda.stream(search.device)))
    xcorr_depthwise_masked.launches += 1
    return out


xcorr_depthwise_masked.launches = 0


def xcorr_depthwise_plain(search, template, valid):
    """Plain PyTorch version: Ht*Wt shifted multiply-adds in f32, i-major
    (the JAX ``xcorr_depthwise`` order), dead slots zeroed."""
    k, hs, ws, c = search.shape
    _, ht, wt, _ = template.shape
    ho, wo = hs - ht + 1, ws - wt + 1
    s = search.float()
    t = template.float()
    acc = torch.zeros((k, ho, wo, c), dtype=torch.float32,
                      device=search.device)
    for i in range(ht):
        for j in range(wt):
            acc = acc + s[:, i:i + ho, j:j + wo, :] * t[:, i:i + 1, j:j + 1, :]
    return torch.where(valid[:, None, None, None], acc, torch.zeros_like(acc))
