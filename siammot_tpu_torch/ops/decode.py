"""Kernel 4: the masked EMM response decode (upsample + penalty + argmax).

Replaces ``siammot_tpu/ops/pallas/decode.py:emm_decode_pallas`` with
``valid``, whole-map form (``_decode_kernel`` through ``_gated_kernel``).
Per live slot: the x16 bicubic upsample ``U . X . U^T`` of 4 channels,
``sigmoid(diff) * sigmoid(ctr)``, the scale/ratio penalty with raw IEEE
divisions, the Hann blend, then the first-occurrence argmax and the cls
probability there.  Dead slots return (0, 0).

On the H100 the decode is bound by operations, and few of them (4.2 M
multiply-adds per slot on 4 KB of input at the main path's s_hi 256):
the point is that the [s_hi, s_hi] maps never leave the chip.  The CUDA
kernel (``cuda/decode.cu``) runs one block per slot over any s <= 32 and
s_hi <= 512 (the JAX whole-map range, ragged sizes such as the AOT
recipe's 464 included), two columns per thread at most, with a
block-wide (value, index) reduction that breaks ties toward the lower
flat index.
"""

from __future__ import annotations

import torch

from . import cuda

_ARGS = (cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.I,
         cuda.I, cuda.I, cuda.F, cuda.F, cuda.I, cuda.P)


def emm_decode(x4: torch.Tensor, wh: torch.Tensor, u: torch.Tensor,
               window: torch.Tensor, valid: torch.Tensor, sigma: float,
               use_centerness: bool):
    """Penalized-confidence argmax over the upsampled response.

    x4 [K, 4, s, s] f32 (cls logit difference, centerness logit, l+r,
    t+b); wh [K, 2] f32 template box extents; u [s_hi, s] f32 bicubic
    matrix; window [s_hi, s_hi] f32 Hann window; valid [K] bool.
    Returns (idx [K] int32 flat argmax, score [K] f32 cls probability
    there).  CUDA tensors launch the kernel; CPU tensors take
    :func:`emm_decode_plain`.
    """
    if x4.device.type == "cpu":
        return emm_decode_plain(x4, wh, u, window, valid, sigma,
                                use_centerness)
    k, four, s, _ = x4.shape
    s_hi = u.shape[0]
    if four != 4 or u.shape != (s_hi, s) or window.shape != (s_hi, s_hi) \
            or wh.shape != (k, 2) or valid.shape != (k,):
        raise ValueError("decode: inconsistent shapes")
    if s > 32 or s_hi > 512:
        raise ValueError(f"decode kernel takes s <= 32 and s_hi <= 512 (the "
                         f"whole-map form), got {s}, {s_hi}")
    for t in (x4, wh, u, window):
        if t.dtype != torch.float32:
            raise TypeError("decode: x4, wh, u and window must be f32")
    for t in (x4, wh, u, window, valid):
        if t.device != x4.device or not t.is_contiguous():
            raise ValueError("decode: inputs must be contiguous, on one "
                             "device")
    if valid.dtype != torch.bool:
        raise TypeError("decode: valid must be bool")
    idx = torch.empty((k,), dtype=torch.int32, device=x4.device)
    score = torch.empty((k,), dtype=torch.float32, device=x4.device)
    fn = cuda.function("siammot_emm_decode", _ARGS)
    # 1 - sigma is rounded from the double, as the reference's Python
    # scalar is, not computed from the f32 sigma
    cuda.check("emm_decode", fn(
        cuda.ptr(x4), cuda.ptr(wh), cuda.ptr(u), cuda.ptr(window),
        cuda.ptr(valid), cuda.ptr(idx), cuda.ptr(score), k, s, s_hi,
        float(sigma), float(1.0 - sigma), int(bool(use_centerness)),
        cuda.stream(x4.device)))
    emm_decode.launches += 1
    return idx, score


emm_decode.launches = 0


def penalized_confidence(x4, wh, u, window, sigma, use_centerness):
    """The decode's per-cell math in plain PyTorch: (p_conf, cls_prob),
    each [K, s_hi, s_hi] f32."""
    up = torch.einsum("oh,kchw->kcow", u, x4)
    up = torch.einsum("pw,kcow->kcop", u, up)
    bw = torch.where(wh[:, 0] == 0, torch.ones_like(wh[:, 0]), wh[:, 0])
    bh = torch.where(wh[:, 1] == 0, torch.ones_like(wh[:, 1]), wh[:, 1])
    cls_prob = torch.sigmoid(up[:, 0])
    conf = cls_prob * torch.sigmoid(up[:, 1]) if use_centerness else cls_prob
    # raw IEEE divisions: zero and negative upsampled extents carry
    # meaning (models/emm.py decode_response in the JAX package)
    scale_w = up[:, 2] / bw[:, None, None]
    scale_h = up[:, 3] / bh[:, None, None]
    scale_w = torch.maximum(scale_w, 1.0 / scale_w)
    scale_h = torch.maximum(scale_h, 1.0 / scale_h)
    penalty = torch.exp((-scale_w * scale_h + 1.0) * 0.1)
    return conf * penalty * (1 - sigma) + sigma * window, cls_prob


def emm_decode_plain(x4, wh, u, window, valid, sigma, use_centerness):
    """Plain PyTorch version: the XLA fused decode's math (first maximal
    index), dead slots (0, 0)."""
    k = x4.shape[0]
    p_conf, cls_prob = penalized_confidence(x4, wh, u, window, sigma,
                                            use_centerness)
    idx = torch.argmax(p_conf.reshape(k, -1), dim=1)
    score = torch.gather(cls_prob.reshape(k, -1), 1, idx[:, None])[:, 0]
    return (torch.where(valid, idx, torch.zeros_like(idx)).to(torch.int32),
            torch.where(valid, score, torch.zeros_like(score)))
