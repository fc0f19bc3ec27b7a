"""Kernels 2 and 6: depthwise cross-correlation, masked and unmasked, and
the gradient of the unmasked form.

Kernel 2 replaces ``siammot_tpu/ops/pallas/xcorr.py:xcorr_depthwise_pallas``
with ``valid`` (``_xcorr_kernel_masked``), reached from
``siammot_tpu/ops/xcorr.py:xcorr_depthwise_masked`` at inference.  Kernel 6
replaces the same Pallas kernel without ``valid`` (``_xcorr_kernel``),
reached from ``siammot_tpu/ops/xcorr.py:xcorr_depthwise_auto`` in training,
and the two calls its custom VJP makes (``_xcorr_bwd``):
``d_template = xcorr(search, g)`` and ``d_search`` = the full convolution
of ``g`` with the template.  Per slot, ``[Hs, Ws, C] * [Ht, Wt, C] ->
[Ho, Wo, C]`` f32, accumulated i-major; masked dead slots write zeros.

On the H100 the op is bound by operations on the CUDA cores (it is
depthwise, so there is no tensor-core form).  Kernel 6's CUDA kernel
(``cuda/xcorr.cu:xcorr6_kernel``) is a persistent grid over (slot, channel
tile, band of output rows) items that stages the next item's inputs in
their own dtype with ``cp.async`` while the current one computes; each
thread streams its search (or ``g``) rows through the template row held in
registers, with the training shapes' widths fixed at compile time.  The
search gradient skips the taps that fall outside ``g`` instead of
correlating a zero-padded copy.  Kernel 2 keeps the first kernels: both
inputs staged as f32, one shared-memory load per multiply-add, and a
banded form for outputs wider or taller than 32 (61x61 at
``SEARCH_REGION`` 5).
"""

from __future__ import annotations

import torch

from . import cuda

_ARGS_MASKED = (cuda.P, cuda.P, cuda.I, cuda.P, cuda.P, cuda.I, cuda.I,
                cuda.I, cuda.I, cuda.I, cuda.I, cuda.P)
_ARGS = (cuda.P, cuda.I, cuda.P, cuda.I, cuda.P, cuda.I, cuda.I, cuda.I,
         cuda.I, cuda.I, cuda.I, cuda.P)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(what, a, b, valid=None):
    """Types, shapes and layout the kernels take; returns (k, c)."""
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise TypeError(f"{what}: inputs bf16 or f32, got {a.dtype}, "
                        f"{b.dtype}")
    k, c = a.shape[0], a.shape[-1]
    if a.dim() != 4 or b.dim() != 4 or b.shape[0] != k or b.shape[-1] != c:
        raise ValueError(f"{what}: inconsistent shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    tensors = (a, b) if valid is None else (a, b, valid)
    for t in tensors:
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous, on one "
                             "device")
    return k, c


def _out_fits(what, ho, wo, w_max=32):
    if not (1 <= ho and 1 <= wo <= w_max) or (w_max == 32 and ho > 32):
        raise ValueError(f"{what} kernel takes outputs up to 32x32 (any "
                         f"height up to width {w_max} for the xcorr), got "
                         f"{ho}x{wo}")


def xcorr_depthwise_masked(search: torch.Tensor, template: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Kernel 2: [K, Hs, Ws, C] x [K, Ht, Wt, C] -> [K, Ho, Wo, C] f32;
    slots with ``valid`` False give zeros.  CUDA tensors launch the kernel;
    CPU tensors take :func:`xcorr_depthwise_plain`."""
    if search.device.type == "cpu":
        return xcorr_depthwise_plain(search, template, valid)
    k, c = _check("xcorr", search, template, valid)
    if template.dtype != search.dtype or valid.dtype != torch.bool \
            or valid.shape != (k,):
        raise TypeError("xcorr: search/template of one dtype, valid [K] "
                        "bool")
    ho = search.shape[1] - template.shape[1] + 1
    wo = search.shape[2] - template.shape[2] + 1
    _out_fits("xcorr", ho, wo, 64)
    out = torch.empty((k, ho, wo, c), dtype=torch.float32,
                      device=search.device)
    fn = cuda.function("siammot_xcorr_masked", _ARGS_MASKED)
    cuda.check("xcorr", fn(
        cuda.ptr(search), cuda.ptr(template),
        int(search.dtype == torch.bfloat16), cuda.ptr(valid), cuda.ptr(out),
        k, *search.shape[1:3], *template.shape[1:3], c,
        cuda.stream(search.device)))
    xcorr_depthwise_masked.launches += 1
    return out


xcorr_depthwise_masked.launches = 0


def _launch(name, a, b, out_hw):
    """One unmasked launch: ``siammot_xcorr`` or ``..._grad_search``."""
    k, c = a.shape[0], a.shape[-1]
    out = torch.empty((k, *out_hw, c), dtype=torch.float32, device=a.device)
    fn = cuda.function(name, _ARGS)
    cuda.check(name, fn(
        cuda.ptr(a), int(a.dtype == torch.bfloat16), cuda.ptr(b),
        int(b.dtype == torch.bfloat16), cuda.ptr(out), k, *a.shape[1:3],
        *b.shape[1:3], c, cuda.stream(a.device)))
    return out


def xcorr_depthwise(search: torch.Tensor,
                    template: torch.Tensor) -> torch.Tensor:
    """Kernel 6, forward: the unmasked xcorr, [K, Ho, Wo, C] f32.  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if search.device.type == "cpu":
        return xcorr_depthwise_plain(search, template)
    _check("xcorr", search, template)
    ho = search.shape[1] - template.shape[1] + 1
    wo = search.shape[2] - template.shape[2] + 1
    _out_fits("xcorr", ho, wo, 64)
    out = _launch("siammot_xcorr", search, template, (ho, wo))
    xcorr_depthwise.launches += 1
    return out


xcorr_depthwise.launches = 0


def xcorr_grad_template(search: torch.Tensor,
                        grad: torch.Tensor) -> torch.Tensor:
    """Kernel 6, template gradient: ``xcorr(search, grad)`` -> [K, Ht, Wt,
    C] f32 (the search may be bf16 and the upstream gradient f32).  CUDA
    tensors launch the unmasked xcorr kernel; CPU tensors take the plain
    version."""
    if search.device.type == "cpu":
        return xcorr_depthwise_plain(search, grad)
    _check("xcorr_grad_template", search, grad)
    ht = search.shape[1] - grad.shape[1] + 1
    wt = search.shape[2] - grad.shape[2] + 1
    _out_fits("xcorr_grad_template", ht, wt)
    out = _launch("siammot_xcorr", search, grad, (ht, wt))
    xcorr_grad_template.launches += 1
    return out


xcorr_grad_template.launches = 0


def xcorr_grad_search(grad: torch.Tensor,
                      template: torch.Tensor) -> torch.Tensor:
    """Kernel 6, search gradient: ``out[y, x] = sum_ij grad[y-i, x-j] *
    template[i, j]`` over the taps inside ``grad`` -> [K, Ho+Ht-1, Wo+Wt-1,
    C] f32.  CUDA tensors launch the kernel; CPU tensors take
    :func:`xcorr_grad_search_plain`."""
    if grad.device.type == "cpu":
        return xcorr_grad_search_plain(grad, template)
    _check("xcorr_grad_search", grad, template)
    hs = grad.shape[1] + template.shape[1] - 1
    ws = grad.shape[2] + template.shape[2] - 1
    _out_fits("xcorr_grad_search", hs, ws)
    out = _launch("siammot_xcorr_grad_search", grad, template, (hs, ws))
    xcorr_grad_search.launches += 1
    return out


xcorr_grad_search.launches = 0


class _Xcorr(torch.autograd.Function):
    """Kernel 6 forward, and its two gradient kernels as the backward,
    with the JAX VJP's casts back to the inputs' dtypes."""

    @staticmethod
    def forward(ctx, search, template):
        ctx.save_for_backward(search, template)
        return xcorr_depthwise(search, template)

    @staticmethod
    def backward(ctx, grad):
        search, template = ctx.saved_tensors
        grad = grad.contiguous()
        d_template = xcorr_grad_template(search, grad).to(template.dtype)
        d_search = xcorr_grad_search(grad, template).to(search.dtype)
        return d_search, d_template


def xcorr_depthwise_auto(search: torch.Tensor,
                         template: torch.Tensor) -> torch.Tensor:
    """Differentiable unmasked xcorr (counterpart of
    ``siammot_tpu/ops/xcorr.py:xcorr_depthwise_auto``): [K, Ho, Wo, C] f32."""
    return _Xcorr.apply(search, template)


def xcorr_depthwise_plain(search, template, valid=None):
    """Plain PyTorch version: Ht*Wt shifted multiply-adds in f32, i-major
    (the JAX ``xcorr_depthwise`` order); with ``valid``, only the live
    slots are computed and dead slots are zeros."""
    if valid is not None:
        live = valid.nonzero()[:, 0]
        part = xcorr_depthwise_plain(search[live], template[live])
        out = part.new_zeros((search.shape[0],) + part.shape[1:])
        out[live] = part
        return out
    k, hs, ws, c = search.shape
    _, ht, wt, _ = template.shape
    ho, wo = hs - ht + 1, ws - wt + 1
    s = search.float()
    t = template.float()
    acc = torch.zeros((k, ho, wo, c), dtype=torch.float32,
                      device=search.device)
    if torch.is_grad_enabled() and (s.requires_grad or t.requires_grad):
        for i in range(ht):
            for j in range(wt):
                acc = acc + s[:, i:i + ho, j:j + wo, :] \
                    * t[:, i:i + 1, j:j + 1, :]
        return acc
    # the same sums without a temporary per tap (several times faster)
    prod = torch.empty_like(acc)
    for i in range(ht):
        for j in range(wt):
            torch.mul(s[:, i:i + ho, j:j + wo, :], t[:, i:i + 1, j:j + 1, :],
                      out=prod)
            acc += prod
    return acc


def xcorr_grad_search_plain(grad, template):
    """Plain version of the search gradient: each template tap adds its
    shifted copy of ``grad``, in f32."""
    k, hg, wg, c = grad.shape
    _, ht, wt, _ = template.shape
    g = grad.float()
    t = template.float()
    out = torch.zeros((k, hg + ht - 1, wg + wt - 1, c), dtype=torch.float32,
                      device=grad.device)
    for i in range(ht):
        for j in range(wt):
            out[:, i:i + hg, j:j + wg, :] += g * t[:, i:i + 1, j:j + 1, :]
    return out
