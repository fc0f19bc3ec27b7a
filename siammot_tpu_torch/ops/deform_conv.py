"""Kernel 9: the deformable convolution (DCNv1), forward on the card, and
its backward.

Counterpart of ``siammot_tpu/ops/deform_conv.py:deform_conv2d`` with its
default route, the guarded Pallas kernel (``_pallas_guarded`` ->
``siammot_tpu/ops/pallas/deform.py:deform_conv_pallas``).  The JAX
function takes one of two routes, which round differently in bf16, and
the port reproduces both:

* **Route A** (the Pallas kernel): 3x3, stride 1, dilation 1, shapes
  under the kernel's VMEM estimate, and every offset's floor in
  [-R, R] (one global min/max over the layer's offsets).  Floor and
  fraction come from the *relative* offset, so the sample position is
  exact; the column weights are rounded to the input dtype, the row
  weights stay f32, and a sample is
  ``(1-fy) * (cx0 v00 + cx1 v01) + fy * (cx0 v10 + cx1 v11)`` in f32.
* **Route B** (the exact "patch" form, ``deform_sample_patch``): every
  other layer, among them the stride-2 first block of each stage.  The
  absolute coordinate ``gy + offset`` is computed in the offsets' dtype
  (JAX promotes int32 + bf16 to bf16, so in bf16 a coordinate loses its
  fraction above 128 and whole pixels above 256), and the four corner
  weights are products in the input dtype; a sample is their f32 sum.

Either way out-of-range corners count zero, the sample is rounded to the
input dtype and one [N, 9C] @ [9C, Co] product with f32 sums gives the
output, rounded once.  The route is decided on the device: the geometry
and the VMEM gate are static, and the in-window test is a reduction that
the kernel's launch runs first and its blocks read as an int flag, so a
frame does not wait for the host.  The reference's 128-lane rule
(``c % 128`` sends narrow layers to the patch form on a TPU only) is a
TPU layout limit and not part of the function.

On the H100 the layer is bound by operations (2 x 9 C Co multiply-adds
per output pixel; DLA-102's 26 layers are about 113 GFLOP a 720p frame)
with a gathered A operand.  The CUDA kernel (``cuda/deform.cu``) is an
implicit GEMM.  In bf16 it runs on Hopper's warpgroup MMA
(``cuda/wgmma.cuh``): a block owns 128 output pixels x 128 output
channels (64 x 256 where Co > 128), so each sample is taken once per
block; two producer warpgroups compute each (pixel, tap)'s corners once,
gather 8 channels a 16-byte load and write the bf16 samples, bit for bit
the reference route's, into a ring beside the weight slice, while two
consumer warpgroups multiply the chunk before.  Where the pixel and
channel tiles alone leave more than half the card's SMs idle, the nine
taps are split over 3 or 9 blocks whose f32 partial sums a second launch
adds and rounds once (:func:`tap_splits`).  In f32 it is an FFMA
implicit GEMM.

The backward (:class:`DeformConv2dFn`) is what the JAX package's
``_pallas_guarded_bwd`` computes: the VJP of the exact patch form (route
B) whichever route the forward took, recomputed from the saved inputs in
their dtype's arithmetic, except that the corner weights' derivatives
are the f32 products' (in bf16 the offsets' gradient is otherwise a
difference of bf16-rounded terms that cancel).  JAX leaves it to XLA;
under ``pallas`` the port runs it as hand-written CUDA
(``cuda/deform_bwd.cu``, :func:`deform_conv2d_bwd`): dKernel = S^T G,
with S route B's samples (bit for bit :func:`sample_plain`'s and JAX's),
in bf16 a ``wgmma`` product whose producers sample S on the fly, so S is
never written (f32 partial sums over the chunks of pixels
:func:`pixel_splits` picks, added in order); in f32 S written and a
cuBLAS product; dS = G W^T on cuBLAS, f32 sums, over the passes of
:func:`ds_passes`; the offsets' gradient from dS and the corners; and the
input's gradient summed for each input pixel over its contributions in
source order, with no float atomics, so the backward is bitwise the same
from call to call.  CPU tensors take :func:`deform_conv2d_bwd_plain`, the
same steps in plain PyTorch and in the same order.  Only x, the offsets
and the kernel are saved; the samples are rebuilt in the backward.

**The forms ``SIAMMOT_DCN_IMPL`` selects** (``impl``, as
``siammot_tpu/ops/deform_conv.py:deform_conv2d`` takes it): ``pallas``
(the default: kernel 9 on the card, route A or B as above), ``patch``
(route B), ``gather4`` (``deform_sample``: four corner gathers whose
products and sums round in the input dtype) and ``shiftwin``
(``_shiftwin_sampled``: the bilinear weights of each integer shift in
[-r, r + 1]^2 times a static strided view of the zero-padded input,
summed in f32; the patch form where an offset's floor leaves [-r, r]).
The JAX package writes the last three in XLA, not Pallas, so here they
are plain PyTorch on the card as on the CPU; only ``pallas`` launches
kernel 9 and its backward.  ``"auto"`` reads the environment variable at
each call.  The other forms' gradients are autograd through their own
plain forms (the JAX package differentiates its own forms), recomputed
in the backward from the saved inputs (:class:`DeformConv2dFn`): under
autograd ``gather4`` would keep its corner tensors, 9 C values a pixel
each, and ``shiftwin`` (2r+2)^2 weight maps a tap, for every layer of
the trunk until the backward; recomputed, one layer's graph lives at a
time.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.nn.functional as F

from . import cuda

R = 2           # in-window radius of route A (floor of every offset)
HALO = R + 2    # the Pallas kernel's row/column halo (for its VMEM gate)
_ARGS = (cuda.P,) * 4 + (cuda.I,) + (cuda.P,) * 2 + (cuda.I,) * 11 \
    + (cuda.P,)
_BWD_SAMPLE_ARGS = (cuda.P,) * 3 + (cuda.I,) * 9 + (cuda.P,)
_BWD_DKERNEL_ARGS = (cuda.P,) * 5 + (cuda.I,) * 10 + (cuda.P,)
_BWD_LISTS_ARGS = (cuda.P,) * 5 + (cuda.I,) * 9 + (cuda.P,)
_BWD_SCATTER_ARGS = (cuda.P,) * 10 + (cuda.I,) * 11 + (cuda.P,)
SMS = 132       # the H100's streaming multiprocessors
L2_BYTES = 50 * 10 ** 6   # the H100's L2 cache
DK_PIXELS = 64  # pixels a step of the bf16 dKernel product (deform_bwd.cu)
DK_MIN_STEPS = 8  # 64-pixel steps a chunk of that product at least
SCAN_TILE = 2048  # counts a block of the lists' scan (deform_bwd.cu)
IMPLS = ("gather4", "patch", "shiftwin", "pallas")


def resolve_impl(impl: str = "auto") -> str:
    """The DCN form a call takes: ``impl``, or for ``"auto"`` the
    environment variable ``SIAMMOT_DCN_IMPL`` (default ``"pallas"``), read
    now; an unknown name raises the JAX package's message."""
    if impl == "auto":
        impl = os.environ.get("SIAMMOT_DCN_IMPL", "pallas")
    if impl not in IMPLS:
        raise ValueError(
            f"unknown DCN impl {impl!r} (from SIAMMOT_DCN_IMPL?); "
            "expected one of 'gather4', 'patch', 'shiftwin', 'pallas'")
    return impl


def window_route_possible(x_shape, kernel_shape, stride: int,
                          dilation: int, itemsize: int) -> bool:
    """The static half of the reference's route choice: the Pallas kernel
    takes 3x3 stride-1 undilated layers whose VMEM estimate, times the
    measured 1.25 overrun, stays under 15 MiB
    (``siammot_tpu/ops/deform_conv.py:214-221``)."""
    kh, kw, _, co = kernel_shape
    if not (kh == kw == 3 and stride == 1 and dilation == 1):
        return False
    _, h, w, c = x_shape
    th, wo, wp = 8, w, w + 2 * HALO
    est = (itemsize * (9 * c * co + (th + 2 * HALO) * wp * c + th * wo * co)
           + 4 * (3 * th * wo * c + th * wo * wp + th * wo * co))
    return est * 1.25 <= 15 * 2 ** 20


def tap_splits(n: int, co: int) -> int:
    """Blocks the nine taps of a bf16 layer are split over (1, 3 or 9):
    the fewest that give half the SMs a block.  On the H100
    (``chip_smoke.py`` phase 2d) an unsplit stage-3 layer of DLA-102 (115
    tiles) beat its 3- and 9-way splits, whose f32 partial sums cost more
    than the idle SMs, while stages 4 and 5 (58 and 30 tiles) ran about
    as fast or fastest split 3 ways."""
    px, ch = (64, 256) if co > 128 else (128, 128)  # the kernel's tile
    tiles = -(-n // px) * -(-co // ch)
    for splits in (1, 3):
        if tiles * splits >= SMS // 2:
            return splits
    return 9


def pixel_splits(n: int, c: int, co: int) -> int:
    """Chunks the N pixels of the bf16 dKernel product are split over: the
    fewest whose blocks (one a tap's 128 channels x 128 outputs, or 64 x
    256 past 128 outputs, and a chunk; one block an SM) fill at least 90%
    of their waves over the card's SMs, else the fullest; a chunk holds at
    least ``DK_MIN_STEPS`` 64-pixel steps (fewer fill the ring only
    briefly; ``time_kernels.py --only deform_bwd`` sweeps the counts).
    Each chunk's f32 partial sum costs 9 C Co x 4 bytes written and read
    again."""
    mc, nt = (64, 256) if co > 128 else (128, 128)
    tiles = 9 * -(-c // mc) * -(-co // nt)
    best, best_fill = 1, 0.0
    most = max(1, -(-n // DK_PIXELS) // DK_MIN_STEPS)
    for splits in range(1, min(most, SMS) + 1):
        blocks = tiles * splits
        fill = blocks / (SMS * -(-blocks // SMS))
        if fill >= 0.9:
            return splits
        if fill > best_fill:
            best, best_fill = splits, fill
    return best


def pixel_chunks(n: int, splits: int) -> list:
    """[(n0, n1)]: the pixels of each of the dKernel product's chunks, in
    order; chunk z holds the 64-pixel steps z K / splits .. (z + 1) K /
    splits - 1 of the K = ceil(N / 64)."""
    k = -(-n // DK_PIXELS)
    return [(min(n, DK_PIXELS * (z * k // splits)),
             min(n, DK_PIXELS * ((z + 1) * k // splits)))
            for z in range(splits)]


def ds_passes(n: int, p: int, c: int, itemsize: int,
              want_x: bool = True) -> list:
    """[(n0, n1)]: the passes over the N source pixels in which the
    backward makes dS = G W^T ([N, 9C] in x's dtype) and uses it, in
    order: two where dS is larger than the card's L2 and half of it with,
    for the input gradient, its f32 sums carried between the passes ([P,
    C], P = B H W) hold fewer bytes than the whole (a large stride-1
    layer), else one."""
    half, whole = -(-n // 2), n * 9 * c * itemsize
    if whole > L2_BYTES and 4 * p * c * want_x + half * 9 * c * itemsize \
            < whole:
        return [(0, half), (half, n)]
    return [(0, n)]


def in_window(offsets: torch.Tensor) -> torch.Tensor:
    """0-dim int32 on the offsets' device: 1 if every offset's floor lies
    in [-R, R] (the reference's global min/max test)."""
    fl = torch.floor(offsets)
    return ((fl.amin() >= -R) & (fl.amax() <= R)).to(torch.int32)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  kernel: torch.Tensor, stride: int = 1,
                  dilation: int = 1, impl: str = "auto") -> torch.Tensor:
    """DCNv1, NHWC.

    x [B, H, W, C]; offsets [B, Ho, Wo, 18] tap-major (dy, dx) pairs in
    x's dtype; kernel [3, 3, C, Co] HWIO in x's dtype; padding = dilation.
    Returns [B, Ho, Wo, Co] in x's dtype.  ``impl`` (:func:`resolve_impl`)
    picks the form (``shiftwin`` at radius ``R``).  Under
    ``pallas`` CUDA tensors launch the kernel (f32 or bf16) and CPU
    tensors take :func:`deform_conv2d_plain`; the other forms are
    :func:`deform_conv2d_form` on either.  Where a gradient is asked for,
    the forward is the same and the backward is :func:`deform_conv2d_bwd`
    under ``pallas``, else :func:`deform_conv2d_vjp`
    (:class:`DeformConv2dFn`).
    """
    impl = resolve_impl(impl)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, offsets, kernel)):
        return DeformConv2dFn.apply(x, offsets, kernel, stride, dilation,
                                    impl)
    return _forward(x, offsets, kernel, stride, dilation, impl)


def _forward(x, offsets, kernel, stride, dilation, impl="pallas"):
    """The forward: under ``pallas`` kernel 9 on CUDA tensors and the
    plain version on CPU ones, else the selected plain form."""
    if impl != "pallas":
        return deform_conv2d_form(x, offsets, kernel, stride, dilation,
                                  impl)
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, kernel, stride, dilation)
    _check(x, offsets, kernel, stride, "deform_conv2d")
    b, ho, wo = offsets.shape[:3]
    co = kernel.shape[3]
    out = _launch(x, offsets, kernel, stride, dilation,
                  tap_splits(b * ho * wo, co))
    deform_conv2d.launches += 1
    return out


def _check(x, offsets, kernel, stride, what):
    """Raise on inputs the CUDA kernels do not take."""
    b, h, w, c = x.shape
    kh, kw, cin, co = kernel.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if (kh, kw) != (3, 3) or cin != c or offsets.shape != (b, ho, wo, 18):
        raise ValueError(f"{what}: x {tuple(x.shape)}, offsets "
                         f"{tuple(offsets.shape)}, kernel "
                         f"{tuple(kernel.shape)} do not fit a 3x3 DCN")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or offsets.dtype != x.dtype or kernel.dtype != x.dtype:
        raise TypeError(f"{what}: x, offsets and kernel must share one "
                        "dtype, f32 or bf16")
    for t in (x, offsets, kernel):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous, on one "
                             "device")
    if x.numel() >= 2 ** 31 or b * ho * wo * max(co, 18) >= 2 ** 31:
        raise ValueError(f"{what}: tensors too large for int32 indexing")


def _launch(x, offsets, kernel, stride, dilation, splits):
    """One launch of the kernel (bf16 taps split over ``splits`` blocks)
    on checked CUDA inputs."""
    b, h, w, c = x.shape
    co = kernel.shape[3]
    ho, wo = offsets.shape[1:3]
    # route A's in-window test runs on the device, in the kernel's launch
    outside = torch.empty((), dtype=torch.int32, device=x.device) \
        if window_route_possible(x.shape, kernel.shape, stride, dilation,
                                 x.element_size()) else None
    out = torch.empty((b, ho, wo, co), dtype=x.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    if not bf16:
        splits = 1
    partial = torch.empty((splits, b * ho * wo, co), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    fn = cuda.function("siammot_deform_conv", _ARGS)
    cuda.check("deform_conv", fn(
        cuda.ptr(x), cuda.ptr(offsets), cuda.ptr(kernel),
        None if outside is None else cuda.ptr(outside), R, cuda.ptr(out),
        None if partial is None else cuda.ptr(partial), b, h,
        w, c, ho, wo, co, stride, dilation, int(bf16), splits,
        cuda.stream(x.device)))
    return out


deform_conv2d.launches = 0


class DeformConv2dFn(torch.autograd.Function):
    """The form's forward (kernel 9, or the plain version on the CPU, under
    ``pallas``); the backward recomputes the form's VJP from the saved
    inputs: route B's under ``pallas`` (:func:`deform_conv2d_bwd`, its
    kernels on the card) and ``patch``
    (``siammot_tpu/ops/deform_conv.py:_pallas_guarded_bwd``), each other
    form's own (:func:`deform_conv2d_vjp`).  Saves only the inputs."""

    @staticmethod
    def forward(ctx, x, offsets, kernel, stride, dilation, impl="pallas"):
        ctx.save_for_backward(x, offsets, kernel)
        ctx.geometry = (stride, dilation)
        ctx.impl = impl
        return _forward(x, offsets, kernel, stride, dilation, impl)

    @staticmethod
    def backward(ctx, grad):
        x, offsets, kernel = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        if ctx.impl == "pallas":
            grads = deform_conv2d_bwd(x, offsets, kernel, grad,
                                      *ctx.geometry, need=need)
        else:
            grads = deform_conv2d_vjp(x, offsets, kernel, grad,
                                      *ctx.geometry, need=need,
                                      impl=ctx.impl)
        return (*grads, None, None, None)


@contextlib.contextmanager
def _f32_sums():
    """cuBLAS products with f32 sums, as the plain version's: no TF32 for
    f32 inputs, and no split-K reduction in bf16 for bf16 ones (the flags
    set for the call, then restored)."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def _opt_ptr(t):
    return None if t is None else cuda.ptr(t)


def deform_conv2d_bwd(x, offsets, kernel, grad, stride: int = 1,
                      dilation: int = 1, need=(True, True, True)):
    """The gradients of (x, offsets, kernel) under the upstream ``grad``
    [B, Ho, Wo, Co], by route B's VJP (``siammot_tpu/ops/deform_conv.py:
    _pallas_guarded_bwd``).  CUDA tensors launch ``cuda/deform_bwd.cu``'s
    kernels: dKernel = S^T G by the ``wgmma`` product in bf16 (S sampled
    on the fly; :func:`pixel_splits`), by the sample kernel and cuBLAS in
    f32; dS = G W^T on cuBLAS, f32 sums, over :func:`ds_passes`; then the
    offsets' and the input's gradients from dS.  CPU tensors take
    :func:`deform_conv2d_bwd_plain`.  Deterministic: every sum in a fixed
    order.  An input that ``need`` leaves out gets None."""
    if x.device.type == "cpu":
        return deform_conv2d_bwd_plain(x, offsets, kernel, grad, stride,
                                       dilation, need)
    _check(x, offsets, kernel, stride, "deform_conv2d_bwd")
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1:3]
    co = kernel.shape[3]
    n = b * ho * wo
    grad = grad.contiguous()
    if grad.shape != (b, ho, wo, co) or grad.dtype != x.dtype \
            or grad.device != x.device:
        raise ValueError(f"deform_conv2d_bwd: grad {tuple(grad.shape)} "
                         f"{grad.dtype} is not the output's")
    if 36 * n >= 2 ** 31 or 9 * c * n >= 2 ** 31:
        raise ValueError("deform_conv2d_bwd: tensors too large for int32 "
                         "indexing")
    want_x, want_off, want_k = (bool(v) for v in need)
    geometry = _bwd_geometry(x, offsets, stride, dilation)
    lists = _bwd_lists(offsets, x.shape, geometry) if want_x \
        else (None,) * 3
    g2 = grad.reshape(n, co)
    dk = dx = doff = None
    if want_k:
        if x.dtype == torch.bfloat16:
            dk = _bwd_dkernel(x, offsets, grad, stride, dilation)
        else:
            s = _bwd_sample(x, offsets, stride, dilation)
            with _f32_sums():
                dk = (s.t() @ g2).reshape(kernel.shape)
            del s
    if want_x or want_off:
        dx = torch.empty_like(x) if want_x else None
        doff = torch.empty_like(offsets) if want_off else None
        passes = ds_passes(n, b * h * w, c, x.element_size(), want_x)
        acc = torch.empty((b * h * w, c), dtype=torch.float32,
                          device=x.device) \
            if want_x and len(passes) > 1 else None
        ds = x.new_empty((passes[0][1] - passes[0][0], 9 * c))
        wt = kernel.reshape(9 * c, co).t()
        fn = cuda.function("siammot_deform_bwd_scatter", _BWD_SCATTER_ARGS)
        for i, (n0, n1) in enumerate(passes):
            part = ds[:n1 - n0]
            with _f32_sums():
                torch.mm(g2[n0:n1], wt, out=part)
            last = i == len(passes) - 1
            cuda.check("deform_bwd_scatter", fn(
                cuda.ptr(x), cuda.ptr(offsets), cuda.ptr(part),
                _opt_ptr(doff), *map(_opt_ptr, lists),
                _opt_ptr(acc if i > 0 else None),
                _opt_ptr(None if last else acc),
                _opt_ptr(dx if last else None), n0, n1, *geometry,
                cuda.stream(x.device)))
    deform_conv2d_bwd.launches += 1
    return dx, doff, dk


deform_conv2d_bwd.launches = 0


def _bwd_geometry(x, offsets, stride, dilation):
    b, h, w, c = x.shape
    return (b, h, w, c, *offsets.shape[1:3], stride, dilation,
            int(x.dtype == torch.bfloat16))


def _bwd_sample(x, offsets, stride, dilation):
    """Route B's samples S [N, 9C] in x's dtype, bit for bit
    :func:`sample_plain`'s, on checked CUDA inputs: the f32 dKernel's
    operand, and the card checks' window onto the samples that the bf16
    product makes on the fly."""
    b, h, w, c = x.shape
    s = x.new_empty((b * offsets.shape[1] * offsets.shape[2], 9 * c))
    fn = cuda.function("siammot_deform_bwd_sample", _BWD_SAMPLE_ARGS)
    cuda.check("deform_bwd_sample", fn(
        cuda.ptr(x), cuda.ptr(offsets), cuda.ptr(s),
        *_bwd_geometry(x, offsets, stride, dilation), cuda.stream(x.device)))
    return s


def _bwd_dkernel(x, offsets, grad, stride, dilation, splits=None):
    """dKernel [3, 3, C, Co] in bf16 by the ``wgmma`` product on checked
    CUDA inputs, its pixels split over ``splits`` chunks (default
    :func:`pixel_splits`)."""
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1:3]
    co = grad.shape[-1]
    if splits is None:
        splits = pixel_splits(b * ho * wo, c, co)
    dk = x.new_empty((3, 3, c, co))
    partial = torch.empty((splits, 9 * c, co), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    fn = cuda.function("siammot_deform_bwd_dkernel", _BWD_DKERNEL_ARGS)
    cuda.check("deform_bwd_dkernel", fn(
        cuda.ptr(x), cuda.ptr(offsets), cuda.ptr(grad), cuda.ptr(dk),
        _opt_ptr(partial), b, h, w, c, ho, wo, co, stride, dilation, splits,
        cuda.stream(x.device)))
    return dk


def _bwd_lists(offsets, x_shape, geometry):
    """The input gradient's lists on checked CUDA inputs: start int32 [P +
    1] (each input pixel's first entry, then the scan's scratch), list
    int32 [36 N] (the source ids 4 (9 n + tap) + corner of the in-range
    corners, each pixel's sorted) and coef f32 [36 N] (the corner
    weights)."""
    b, h, w, _ = x_shape
    p, n = b * h * w, b * offsets.shape[1] * offsets.shape[2]
    i32 = dict(dtype=torch.int32, device=offsets.device)
    count = torch.empty(p, **i32)
    start = torch.empty(p + 1 + -(-p // SCAN_TILE), **i32)
    lst = torch.empty(36 * n, **i32)
    coef = torch.empty(36 * n, dtype=torch.float32, device=offsets.device)
    fn = cuda.function("siammot_deform_bwd_lists", _BWD_LISTS_ARGS)
    cuda.check("deform_bwd_lists", fn(
        cuda.ptr(offsets), cuda.ptr(count), cuda.ptr(start), cuda.ptr(lst),
        cuda.ptr(coef), *geometry, cuda.stream(offsets.device)))
    return start, lst, coef


def dkernel_plain(x, offsets, grad, stride: int = 1, dilation: int = 1,
                  splits: int = 1):
    """Plain PyTorch version of the bf16 dKernel product's arithmetic:
    route B's samples times the upstream gradient, f32 sums over each of
    :func:`pixel_chunks`' chunks, the chunks' sums added in order and
    rounded once to x's dtype.  [3, 3, C, Co]."""
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1:3]
    co = grad.shape[-1]
    n = b * ho * wo
    with torch.no_grad():
        s = sample_plain(x, offsets, stride, dilation, route_a=False)
        s = s.reshape(n, 9 * c).float()
        g32 = grad.reshape(n, co).float()
        total = None
        for n0, n1 in pixel_chunks(n, splits):
            part = s[n0:n1].t() @ g32[n0:n1]
            total = part if total is None else total + part
    return total.to(x.dtype).reshape(3, 3, c, co)


def deform_conv2d_bwd_plain(x, offsets, kernel, grad, stride: int = 1,
                            dilation: int = 1, need=(True, True, True)):
    """Plain PyTorch version of :func:`deform_conv2d_bwd`: route B's VJP
    step by step, without autograd, in the kernels' order and rounding.
    S = route B's samples (:func:`sample_plain`); dKernel = S^T G with f32
    sums, rounded once; dS = G W^T likewise, rounded to x's dtype; the
    offsets' gradient, per (pixel, tap), from the f32 sums over channels
    of dS times each corner's values, gw00 .. gw11, as
    ``(gw10 ax + gw11 fx) - (gw00 ax + gw01 fx)`` for dy and ``(gw01 ay +
    gw11 fy) - (gw00 ay + gw10 fy)`` for dx (fy, fx the fractions, ay = 1
    - fy, ax = 1 - fx, all f32), rounded once; the input's gradient, each
    input pixel's contributions dS * w (w the corner weight in x's dtype,
    the product in f32) summed in source order (:func:`_sum_in_order`)
    and rounded once."""
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1:3]
    co = kernel.shape[3]
    n, dt = b * ho * wo, x.dtype
    dx = doff = dk = None
    with torch.no_grad():
        g32 = grad.reshape(n, co).float()
        if need[2]:
            s = sample_plain(x, offsets, stride, dilation, route_a=False)
            dk = (s.reshape(n, 9 * c).float().t() @ g32).to(dt).reshape(
                kernel.shape)
        if not (need[0] or need[1]):
            return dx, doff, dk
        ds = (g32 @ kernel.reshape(9 * c, co).float().t()).to(dt).float()
        ds = ds.reshape(b, ho, wo, 9, c)
        off = offsets.reshape(b, ho, wo, 9, 2)
        gy, gx = _taps(b, ho, wo, stride, dilation, x.device)
        y0, x0, fy, fx = _route_b_point(gy, gx, off[..., 0], off[..., 1], dt)
        if need[1]:
            corner = _corners(x.reshape(b, h * w, c).float(), y0, x0, h, w)
            gw = [(ds * corner(i // 2, i % 2)).sum(-1) for i in range(4)]
            fy32, fx32 = fy.float(), fx.float()
            ay, ax = 1 - fy32, 1 - fx32
            d_y = (gw[2] * ax + gw[3] * fx32) - (gw[0] * ax + gw[1] * fx32)
            d_x = (gw[1] * ay + gw[3] * fy32) - (gw[0] * ay + gw[2] * fy32)
            doff = torch.stack([d_y, d_x], -1).reshape(offsets.shape).to(
                offsets.dtype)
        if need[0]:
            dest, vals = _dx_contributions(ds, y0, x0, fy, fx, h, w)
            key = torch.arange(len(dest), device=x.device)
            dx = _sum_in_order(dest, key, vals, b * h * w).to(dt).reshape(
                x.shape)
    return dx, doff, dk


def _dx_contributions(ds, y0, x0, fy, fx, h: int, w: int):
    """The input gradient's contributions in source order (pixel, tap,
    corner): the destination row of each in [B*H*W] (-1 out of range)
    [N*36], and dS times the corner weight, an f32 product [N*36, C]."""
    b, c = ds.shape[0], ds.shape[-1]
    wy, wx = (1 - fy, fy), (1 - fx, fx)
    bi = torch.arange(b, device=ds.device).view(b, 1, 1, 1)
    dest, vals = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            dest.append(torch.where(ok, (bi * h + yi) * w + xi, -1))
            vals.append(ds * (wy[dy] * wx[dx]).float()[..., None])
    return (torch.stack(dest, -1).reshape(-1),
            torch.stack(vals, -2).reshape(-1, c))


def _sum_in_order(dest, key, vals, size: int, init=None):
    """out [size, C] f32: row q the sum of ``vals[i]`` over the i with
    ``dest[i] == q`` (-1: dropped), taken from 0 (or from ``init``'s row
    q) in ascending ``key`` (unique) order, whatever order the list comes
    in: the kernel's fixed order."""
    keep = dest >= 0
    dest, key, vals = dest[keep], key[keep], vals[keep]
    order = torch.argsort(dest * (int(key.max()) + 1 if len(key) else 1)
                          + key)
    dest, vals = dest[order], vals[order]
    counts = torch.bincount(dest, minlength=size)
    rank = torch.arange(len(dest), device=dest.device) \
        - (torch.cumsum(counts, 0) - counts)[dest]
    out = torch.zeros(size, vals.shape[-1], dtype=torch.float32,
                      device=vals.device) if init is None else init.clone()
    # the r-th term of every row at once: each row at most once a pass
    by_rank = torch.argsort(rank, stable=True)
    at = 0
    for cnt in torch.bincount(rank).tolist():
        idx = by_rank[at:at + cnt]
        out[dest[idx]] = out[dest[idx]] + vals[idx]
        at += cnt
    return out


def deform_conv2d_vjp(x, offsets, kernel, grad, stride: int = 1,
                      dilation: int = 1, need=(True, True, True),
                      impl: str = "patch"):
    """The gradients of (x, offsets, kernel) under the upstream ``grad``:
    autograd through the form's plain version, recomputed from the inputs
    in their dtype's arithmetic.  Under ``pallas`` and ``patch`` that is
    route B (``sample_plain(..., route_a=False)`` and the product, the
    corner weights' derivatives in f32), as the JAX package
    differentiates its exact patch form for either forward route; under
    ``gather4`` and ``shiftwin`` the form itself (``shiftwin``'s patch
    fallback where the forward took it).  An input that ``need`` leaves
    out gets None."""
    if impl == "pallas":
        impl = "patch"
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n))
                  for t, n in zip((x, offsets, kernel), need)]
        out = deform_conv2d_form(*leaves, stride, dilation, impl)
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(got) if t.requires_grad else None for t in leaves)


def _taps(b, ho, wo, stride, dilation, device):
    """Integer base coordinates [1, Ho, 1, 9] and [1, 1, Wo, 9] of the
    nine taps (tap-major: row t // 3, column t % 3)."""
    t = torch.arange(9, device=device)
    gy = (torch.arange(ho, device=device)[:, None] * stride - dilation
          + (t // 3)[None] * dilation)
    gx = (torch.arange(wo, device=device)[:, None] * stride - dilation
          + (t % 3)[None] * dilation)
    return gy[None, :, None, :], gx[None, None, :, :]


def _corners(flat, y0, x0, h: int, w: int):
    """``corner(dy, dx)``: the rows of ``flat`` [B, H*W, C] at (y0 + dy,
    x0 + dx) for integer coordinates [B, Ho, Wo, 9], as [B, Ho, Wo, 9, C]
    in ``flat``'s dtype, corners outside the map zero."""
    b, _, c = flat.shape

    def corner(dy, dx):
        yi, xi = y0 + dy, x0 + dx
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v.reshape(*y0.shape, c) * ok[..., None]

    return corner


def _route_b_point(gy, gx, oy, ox, dt):
    """Route B's corner (y0, x0) and fractions (fy, fx, in x's dtype
    ``dt``) of each sample: the absolute coordinate in the offsets'
    dtype."""
    cy_abs = gy.to(oy.dtype) + oy
    cx_abs = gx.to(ox.dtype) + ox
    fly, flx = torch.floor(cy_abs), torch.floor(cx_abs)
    return (fly.long(), flx.long(), (cy_abs - fly).to(dt),
            (cx_abs - flx).to(dt))


def sample_plain(x, offsets, stride, dilation, route_a: bool):
    """The bilinear samples [B, Ho, Wo, 9, C] in x's dtype, by the route's
    arithmetic (see the module docstring)."""
    b, h, w, c = x.shape
    _, ho, wo, _ = offsets.shape
    dt = x.dtype
    off = offsets.reshape(b, ho, wo, 9, 2)
    oy, ox = off[..., 0], off[..., 1]
    gy, gx = _taps(b, ho, wo, stride, dilation, x.device)
    if route_a:
        # the fraction in f32: XLA keeps the reference's bf16 offset minus
        # its floor in f32 (the conversions cancel inside the jitted op)
        oy, ox = oy.float(), ox.float()
        fly, flx = torch.floor(oy), torch.floor(ox)
        fy, fx = oy - fly, ox - flx
        y0 = gy + fly.long()
        x0 = gx + flx.long()
        cy = (1.0 - fy, fy)
        cx = ((1.0 - fx).to(dt).float(), fx.to(dt).float())
    else:
        y0, x0, fy, fx = _route_b_point(gy, gx, oy, ox, dt)
        wy, wx = (1 - fy, fy), (1 - fx, fx)
    corner = _corners(x.reshape(b, h * w, c).float(), y0, x0, h, w)
    if route_a:
        part = [cx[0][..., None] * corner(r, 0)
                + cx[1][..., None] * corner(r, 1) for r in (0, 1)]
        s = cy[0][..., None] * part[0] + cy[1][..., None] * part[1]
    else:
        # the weights' values are the input dtype's products, their
        # derivatives those of the f32 products: in bf16 the offsets'
        # gradient is a difference of the corners' terms, which rounded
        # each to bf16 cancel to errors of several percent of its scale
        # where the features share a large positive mean (post-ReLU)
        fy32, fx32 = fy.float(), fx.float()   # one cast: f32 sums
        wy32, wx32 = (1 - fy32, fy32), (1 - fx32, fx32)
        s = 0
        for dy in (0, 1):
            for dx in (0, 1):
                w32 = wy32[dy] * wx32[dx]
                wgt = w32 + ((wy[dy] * wx[dx]).float() - w32).detach()
                s = s + wgt[..., None] * corner(dy, dx)
    return s.to(dt)


def _route(x, offsets, kernel, stride, dilation, route_a: bool):
    """One route's samples and the [N, 9C] @ [9C, Co] product with f32
    sums, rounded once to x's dtype."""
    b = x.shape[0]
    c, co = kernel.shape[2], kernel.shape[3]
    s = sample_plain(x, offsets, stride, dilation, route_a)
    _, ho, wo = s.shape[:3]
    out = s.reshape(-1, 9 * c).float() @ kernel.reshape(9 * c, co).float()
    return out.to(x.dtype).reshape(b, ho, wo, co)


def deform_conv2d_plain(x, offsets, kernel, stride: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version: the route decision, the exact 2x2 gather of
    every sample in the route's arithmetic, and one [N, 9C] @ [9C, Co]
    product with f32 sums, rounded once to x's dtype."""
    route_a = window_route_possible(x.shape, kernel.shape, stride, dilation,
                                    x.element_size()) \
        and bool(in_window(offsets))
    return _route(x, offsets, kernel, stride, dilation, route_a)


def deform_conv2d_form(x, offsets, kernel, stride: int = 1,
                       dilation: int = 1, impl: str = "patch",
                       shift_r: int = R) -> torch.Tensor:
    """The plain PyTorch form of ``impl`` (``"patch"``, ``"gather4"`` or
    ``"shiftwin"`` of radius ``shift_r``): its samples and one [N, 9C] @ [9C, Co] product with
    f32 sums, rounded once to x's dtype, as the JAX forms' ``matmul``."""
    if impl == "patch":
        return _route(x, offsets, kernel, stride, dilation, route_a=False)
    if impl == "gather4":
        s = sample_gather4(x, offsets, stride, dilation)
    elif impl == "shiftwin":
        fl = torch.floor(offsets)
        # the lax.cond's predicate, read on the host
        if not bool((fl.amin() >= -shift_r) & (fl.amax() <= shift_r)):
            return _route(x, offsets, kernel, stride, dilation,
                          route_a=False)
        s = sample_shiftwin(x, offsets, stride, dilation, shift_r)
    else:
        raise ValueError(f"deform_conv2d_form: no plain form {impl!r}")
    b, ho, wo = s.shape[:3]
    c, co = kernel.shape[2], kernel.shape[3]
    out = s.reshape(-1, 9 * c).float() @ kernel.reshape(9 * c, co).float()
    return out.to(x.dtype).reshape(b, ho, wo, co)


def sample_gather4(x, offsets, stride, dilation):
    """``deform_sample``: the absolute coordinate in the offsets' dtype (as
    route B), four corner gathers of x in its dtype, out-of-range corners
    zero, and ``v00 (1-wy)(1-wx) + v01 (1-wy) wx + v10 wy (1-wx) + v11 wy
    wx`` with every product and sum rounded to x's dtype, left to right.
    Returns [B, Ho, Wo, 9, C]."""
    b, h, w, c = x.shape
    _, ho, wo, _ = offsets.shape
    dt = x.dtype
    off = offsets.reshape(b, ho, wo, 9, 2)
    gy, gx = _taps(b, ho, wo, stride, dilation, x.device)
    cy = gy.to(off.dtype) + off[..., 0]
    cx = gx.to(off.dtype) + off[..., 1]
    fly, flx = torch.floor(cy), torch.floor(cx)
    wy = (cy - fly).to(dt)[..., None]
    wx = (cx - flx).to(dt)[..., None]
    corner = _corners(x.reshape(b, h * w, c), fly.long(), flx.long(), h, w)
    return (corner(0, 0) * (1 - wy) * (1 - wx)
            + corner(0, 1) * (1 - wy) * wx
            + corner(1, 0) * wy * (1 - wx)
            + corner(1, 1) * wy * wx)


def sample_shiftwin(x, offsets, stride, dilation, r):
    """``_shiftwin_sampled``: for each tap, the sum over the integer shifts
    (sy, sx) in [-r, r + 1]^2 of the separable weight ``wy * wx`` (x's
    dtype: each is ``(1 - f) * [floor == s] + f * [floor == s - 1]`` of
    the *relative* offset) times the static strided view of the
    zero-padded input at the tap's position plus (sy, sx), summed in f32
    and rounded once.  The weight times the view is an f32 product: JAX
    writes it in x's dtype and converts it to f32, and XLA, which allows
    excess precision, drops that product's rounding (in bf16, rounding
    it moves 30% of the samples, by up to 0.7% of their scale).  Exact
    where every offset's floor lies in [-r, r]; the caller takes the
    patch form elsewhere.  Returns [B, Ho, Wo, 9, C]."""
    b, h, w, c = x.shape
    _, ho, wo, _ = offsets.shape
    dt = x.dtype
    pad = dilation
    off = offsets.reshape(b, ho, wo, 9, 2)
    fly, flx = torch.floor(off[..., 0]), torch.floor(off[..., 1])
    fy, fx = (off[..., 0] - fly).to(dt), (off[..., 1] - flx).to(dt)
    iy, ix = fly.long(), flx.long()
    lo = pad + r
    xp = F.pad(x, (0, 0, lo, lo + 1, lo, lo + 1))
    ey, ex = (ho - 1) * stride + 1, (wo - 1) * stride + 1

    def view(ay, ax):
        return xp[:, ay + lo:ay + lo + ey:stride, ax + lo:ax + lo + ex:stride]

    sampled = []
    for t in range(9):
        dy, dx = (t // 3) * dilation - pad, (t % 3) * dilation - pad
        iy_t, ix_t, fy_t, fx_t = iy[..., t], ix[..., t], fy[..., t], fx[..., t]
        acc = torch.zeros((b, ho, wo, c), dtype=torch.float32,
                          device=x.device)
        for sy in range(-r, r + 2):
            wy = (1 - fy_t) * (iy_t == sy) + fy_t * (iy_t == sy - 1)
            for sx in range(-r, r + 2):
                wx = (1 - fx_t) * (ix_t == sx) + fx_t * (ix_t == sx - 1)
                # f32 weight times x's view: PyTorch promotes the view
                # to f32, and autograd keeps the view, not a copy
                acc = acc + (wy * wx).float()[..., None] * view(dy + sy,
                                                                dx + sx)
        sampled.append(acc.to(dt))
    return torch.stack(sampled, dim=3)
