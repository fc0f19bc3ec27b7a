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

On the H100 kernels 2 and 6's xcorr and search gradient are bound by
operations on the CUDA cores and run one CUDA kernel
(``cuda/xcorr.cu:xcorr6_kernel``): a persistent grid over (slot,
channel tile, band of output rows) items that stages the next item's
inputs in their own dtype with ``cp.async`` while the current one
computes; each thread streams its search (or ``g``) rows through the
template row held in registers, over output segments of a compile-time
width (16 for a 15-wide template, so 16x16 and SEARCH_REGION 5's 61x61
outputs both run unrolled).  Kernel 2's ``valid`` orders the slots live
first on the device, so the live items spread over the blocks; a dead
slot's items read nothing and write zeros, and a live slot's outputs are
bitwise kernel 6's.  The search gradient skips the taps that fall outside
``g`` instead of correlating a zero-padded copy; past the training shapes
(a 61x61 ``g`` and a 75x75 output at SEARCH_REGION 5) it runs in bands of
output rows, each staging only the rows of ``g`` it meets, and column
segments, of 16 outputs for a 15-wide template (``g`` streamed through the
template row in registers) and of at most 64 otherwise
(:func:`grad_search_plan`).  The template gradient, whose taps (``g``) are
wider than its output, runs on the tensor cores
(``cuda/xcorr_grad.cu:xcorr_grad_template_mma``): per search row a small
matrix product of shifted rows of ``g`` with a Hankel matrix of the row,
``mma.sync`` on bf16 terms that hold the f32 inputs exactly, in
compensated sums (:func:`grad_template_plan`), held on the card to the
exact correlation (:func:`xcorr_depthwise_exact`); at
the default training shape's 16-wide ``g`` ``xcorr6_kernel``'s
compile-time form (15 outputs a segment) stays, being the faster there.
"""

from __future__ import annotations

import functools

import torch

from . import cuda

_ARGS_MASKED = (cuda.P, cuda.P, cuda.I, cuda.P, cuda.P, cuda.I, cuda.I,
                cuda.I, cuda.I, cuda.I, cuda.I, cuda.P)
_ARGS = (cuda.P, cuda.I, cuda.P, cuda.I, cuda.P, cuda.I, cuda.I, cuda.I,
         cuda.I, cuda.I, cuda.I, cuda.P)
_ARGS_GRAD_SEARCH = _ARGS[:-1] + (cuda.I, cuda.I, cuda.P)
_ARGS_GRAD_TEMPLATE = _ARGS[:-1] + (cuda.I, cuda.P)
_DTYPES = (torch.float32, torch.bfloat16)
W_GEN = 64          # outputs a thread accumulates, generic widths
MAX_THREADS = 256   # threads a block of the xcorr kernel at most
GT_TILE = 8         # channels an item of the template gradient, a warp each
# the upstream gradient's width whose template gradient keeps
# xcorr6_kernel's compile-time form (the default training shape), which
# ran faster there than the tensor-core kernel
XCORR6_GRAD_WIDTH = 16


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


def _out_fits(what, ho, wo, w_max):
    """Kernels 2 and 6's xcorr take outputs of any height, up to 64 wide
    (``w_max`` 64) or of any width for a 15- or 16-wide template, whose
    rows run in compile-time segments (``w_max`` None: SEARCH_REGION 5.5's
    68-wide response)."""
    if w_max is None:
        w_max = wo
    if not (1 <= ho and 1 <= wo <= w_max):
        raise ValueError(f"{what} kernel takes outputs up to {w_max} wide, "
                         f"got {ho}x{wo}")


def _xcorr_width(template) -> int | None:
    """The widest xcorr output the kernel takes for ``template``: any for
    a 15- or 16-wide one (segments of 16 or 15 outputs), else 64."""
    return None if template.shape[2] in (15, 16) else 64


def _row_stride(nbytes: int, groups: int, width: int) -> int:
    """``cuda/xcorr.cu:row_stride``: the smallest row stride (bytes, a
    multiple of 16) from ``nbytes`` up at which the ``groups`` rows a warp
    reads, ``width`` bytes each, fall in distinct banks."""
    rs = -(-nbytes // 16) * 16
    while not all(width <= (m * rs) % 128 <= 128 - width
                  for m in range(1, groups)):
        rs += 16
    return rs


def grad_search_plan(hg: int, wg: int, ht: int, wt: int, g_size: int,
                     t_size: int, smem_limit: int) -> tuple:
    """(output rows a band, column segments) of the search gradient's
    kernel for a ``[hg, wg]`` upstream gradient of ``g_size``-byte elements
    and a ``[ht, wt]`` template of ``t_size``-byte ones, two shared-memory
    stages within ``smem_limit`` bytes.  One band of every output row where
    that fits, at most 64 outputs wide and two rows a row thread (the
    training shapes, as before); else the tallest band of at most one row
    a row thread whose stages fit, and segments of 16 outputs for a
    15-wide template (the kernel's compile-time segment) or the fewest of
    at most 64.  Raises with the limit where one row's band does not
    fit."""
    ho, wo = hg + ht - 1, wg + wt - 1
    tile = 16 if g_size == 2 and t_size == 2 else 8
    cap = MAX_THREADS // tile
    rs = _row_stride(wg * tile * g_size, 32 // tile, tile * g_size)

    def smem(rows):
        stage = min(hg, rows + ht - 1) * rs + ht * wt * tile * t_size
        return 2 * (-(-stage // 16) * 16)

    if wo <= W_GEN and ho <= 2 * cap and smem(ho) <= smem_limit:
        return ho, 1
    segments = -(-wo // (16 if wt == 15 else W_GEN))
    for rows in range(min(ho, cap), 0, -1):
        if smem(rows) <= smem_limit:
            return rows, segments
    raise ValueError(
        f"xcorr_grad_search: a band of one output row stages "
        f"{min(hg, ht)} rows of the {wg}-wide gradient and the {ht}x{wt} "
        f"template in two stages, {smem(1)} bytes, past the {smem_limit} "
        f"bytes of shared memory a block may use")


def grad_template_plan(hs: int, ws: int, hg: int, wg: int, s_size: int,
                       g_size: int, smem_limit: int) -> tuple:
    """(n-tiles, row blocks, search rows an A tile serves, search rows a
    band, shared-memory bytes) of the template gradient's kernel for a
    ``[hs, ws]`` search of ``s_size``-byte elements and a ``[hg, wg]``
    upstream gradient of ``g_size``-byte ones: ``cuda/xcorr_grad.cu:
    geometry``'s layout.  Its output is up to 32 wide (one, two or four
    n8 tiles) and of any height, cut into row blocks of equal height of
    at most 16 (one m16 tile), each over its own ``hb + hg - 1`` search
    rows; an A tile of 16 rows of ``g`` serves ``p = min(4 / n-tiles, 17
    - hb)`` search rows.  The band is the tallest multiple of ``p`` (at
    most a block's every search row) whose ring of ``g`` rows, split
    planes and raw buffer fit two blocks an SM, else one; raises with the
    limit where a band of ``p`` rows does not fit or the output is past
    32 wide."""
    ht, wt = hs - hg + 1, ws - wg + 1
    if not (ht >= 1 and 1 <= wt <= 32 and hg >= 1 and wg >= 1):
        raise ValueError(f"xcorr_grad_template kernel takes outputs up to "
                         f"32 wide, got {ht}x{wt}")
    blocks = -(-ht // 16)
    hb = -(-ht // blocks)
    nt = 1 if wt <= 8 else 2 if wt <= 16 else 4
    p = min(4 // nt, 17 - hb)
    ks = -(-wg // 16)
    rb = 32 * (ks if ks <= 2 else -(-ks // 4) * 4)
    key_div = 8 // min(rb // 16, 8)
    srow = -(-2 * max(ws + 1, 8 * (2 * ks + nt - 2) + 16) // 16) * 16
    tg, ts = (3 if g_size == 4 else 1), (3 if s_size == 4 else 1)

    def smem(br):
        ring = -(-(br + 16 - p) // key_div) * key_div
        copy = br * srow
        copy += (64 - copy % 128) % 128
        s_bytes = max(ts * GT_TILE * (2 * copy + 16),
                      hb * wt * GT_TILE * 4)
        return (rb + tg * GT_TILE * (ring * rb + 16)
                + -(-s_bytes // 16) * 16
                + -(-br * wg * GT_TILE * g_size // 128) * 128
                + -(-br * ws * GT_TILE * s_size // 128) * 128)

    two = (smem_limit + 1024) // 2 - 1024   # two blocks an SM
    tallest = -(-(hb + hg - 1) // p) * p
    for budget in (two, smem_limit):
        for br in range(tallest, 0, -p):
            if smem(br) <= budget:
                return nt, blocks, p, br, smem(br)
    raise ValueError(
        f"xcorr_grad_template: a band of {p} search rows of the {ws}-wide "
        f"search and the ring of the {wg}-wide gradient take {smem(p)} "
        f"bytes, past the {smem_limit} bytes of shared memory a block may "
        f"use")


@functools.cache
def _smem_limit(device_index: int) -> int:
    """Shared memory a block may opt in to on the device, bytes."""
    with torch.cuda.device(device_index):
        return cuda.function("siammot_smem_optin", ())()


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
    cuda.check_extent("xcorr", search, template, (k, ho, wo, c))
    _out_fits("xcorr", ho, wo, _xcorr_width(template))
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


def _launch(name, a, b, out_hw, plan=()):
    """One unmasked launch of ``xcorr6_kernel``: ``siammot_xcorr``, or
    ``..._grad_search`` with its ``plan`` (:func:`grad_search_plan`);
    counted in ``_launch.launches``."""
    k, c = a.shape[0], a.shape[-1]
    out = torch.empty((k, *out_hw, c), dtype=torch.float32, device=a.device)
    fn = cuda.function(name, _ARGS_GRAD_SEARCH if plan else _ARGS)
    cuda.check(name, fn(
        cuda.ptr(a), int(a.dtype == torch.bfloat16), cuda.ptr(b),
        int(b.dtype == torch.bfloat16), cuda.ptr(out), k, *a.shape[1:3],
        *b.shape[1:3], c, *plan, cuda.stream(a.device)))
    _launch.launches += 1
    return out


_launch.launches = 0


def xcorr_depthwise(search: torch.Tensor,
                    template: torch.Tensor) -> torch.Tensor:
    """Kernel 6, forward: the unmasked xcorr, [K, Ho, Wo, C] f32.  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if search.device.type == "cpu":
        return xcorr_depthwise_plain(search, template)
    _check("xcorr", search, template)
    ho = search.shape[1] - template.shape[1] + 1
    wo = search.shape[2] - template.shape[2] + 1
    _out_fits("xcorr", ho, wo, _xcorr_width(template))
    out = _launch("siammot_xcorr", search, template, (ho, wo))
    xcorr_depthwise.launches += 1
    return out


xcorr_depthwise.launches = 0


def xcorr_grad_template(search: torch.Tensor,
                        grad: torch.Tensor) -> torch.Tensor:
    """Kernel 6, template gradient: ``xcorr(search, grad)`` -> [K, Ht, Wt,
    C] f32 (the search may be bf16 and the upstream gradient f32).  CUDA
    tensors launch a kernel: for a 16-wide ``grad`` (the default training
    shape) ``xcorr6_kernel``'s compile-time form, which ran faster there
    than the tensor-core kernel; else the tensor-core kernel
    (:func:`_grad_template_mma`, outputs up to 32 wide).  CPU tensors take
    the plain version."""
    if search.device.type == "cpu":
        return xcorr_depthwise_plain(search, grad)
    _check("xcorr_grad_template", search, grad)
    if grad.shape[2] == XCORR6_GRAD_WIDTH:
        out = _launch("siammot_xcorr", search, grad,
                      (search.shape[1] - grad.shape[1] + 1,
                       search.shape[2] - grad.shape[2] + 1))
    else:
        out = _grad_template_mma(search, grad)
    xcorr_grad_template.launches += 1
    return out


def _grad_template_mma(search, grad):
    """The template gradient's tensor-core kernel
    (``cuda/xcorr_grad.cu``) at any shape it takes
    (:func:`grad_template_plan`)."""
    _check("xcorr_grad_template", search, grad)
    (k, hs, ws, c), (_, hg, wg, _) = search.shape, grad.shape
    band_rows = grad_template_plan(
        hs, ws, hg, wg, search.element_size(), grad.element_size(),
        _smem_limit(search.device.index if search.device.index is not None
                    else torch.cuda.current_device()))[3]
    out = torch.empty((k, hs - hg + 1, ws - wg + 1, c), dtype=torch.float32,
                      device=search.device)
    cuda.check_extent("xcorr_grad_template", search, grad, out)
    fn = cuda.function("siammot_xcorr_grad_template", _ARGS_GRAD_TEMPLATE)
    cuda.check("xcorr_grad_template", fn(
        cuda.ptr(search), int(search.dtype == torch.bfloat16),
        cuda.ptr(grad), int(grad.dtype == torch.bfloat16), cuda.ptr(out), k,
        hs, ws, hg, wg, c, band_rows, cuda.stream(search.device)))
    _grad_template_mma.launches += 1
    return out


_grad_template_mma.launches = 0


xcorr_grad_template.launches = 0


def xcorr_grad_search(grad: torch.Tensor,
                      template: torch.Tensor) -> torch.Tensor:
    """Kernel 6, search gradient: ``out[y, x] = sum_ij grad[y-i, x-j] *
    template[i, j]`` over the taps inside ``grad`` -> [K, Ho+Ht-1, Wo+Wt-1,
    C] f32, any size whose one-row band fits in shared memory
    (:func:`grad_search_plan`).  CUDA tensors launch the kernel; CPU
    tensors take :func:`xcorr_grad_search_plain`."""
    if grad.device.type == "cpu":
        return xcorr_grad_search_plain(grad, template)
    _check("xcorr_grad_search", grad, template)
    (_, hg, wg, _), (_, ht, wt, _) = grad.shape, template.shape
    plan = grad_search_plan(hg, wg, ht, wt, grad.element_size(),
                            template.element_size(),
                            _smem_limit(grad.device.index
                                        if grad.device.index is not None
                                        else torch.cuda.current_device()))
    out = _launch("siammot_xcorr_grad_search", grad, template,
                  (hg + ht - 1, wg + wt - 1), plan)
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


def xcorr_depthwise_exact(search, template):
    """The correlation summed in f64 and rounded once to f32: the yardstick
    of the template gradient's tensor-core kernel on the card, whose sums
    are near exact.  The plain version's f32 sums in JAX's order stray
    from it on their own near zero over many taps (up to 1.8x atol 1e-4 +
    rtol 1e-3 over SEARCH_REGION 5's 3721, N(0, 1) inputs).  A check, not
    differentiated: inputs that require grad are detached."""
    k, hs, ws, c = search.shape
    _, ht, wt, _ = template.shape
    ho, wo = hs - ht + 1, ws - wt + 1
    s = search.detach().double()
    t = template.detach().double()
    acc = torch.zeros((k, ho, wo, c), dtype=torch.float64,
                      device=search.device)
    prod = torch.empty_like(acc)
    for i in range(ht):
        for j in range(wt):
            torch.mul(s[:, i:i + ho, j:j + wo, :], t[:, i:i + 1, j:j + 1, :],
                      out=prod)
            acc += prod
    return acc.float()


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
