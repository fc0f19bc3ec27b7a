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
difference of bf16-rounded terms that cancel).  JAX leaves it to XLA,
so here it is plain PyTorch (a gather, and a scatter-add for the input's
gradient, whose atomics sum in no fixed order on the card: that gradient
is not bitwise from run to run there).  Only x, the offsets and the
kernel are saved; the four corner tensors of the samples are rebuilt in
the backward.

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
kernel 9.  ``"auto"`` reads the environment variable at each call.
Each form's gradient is autograd through its own plain form (the JAX
package differentiates its own forms), recomputed in the backward from
the saved inputs (:class:`DeformConv2dFn`): under autograd ``gather4``
would keep its corner tensors, 9 C values a pixel each, and
``shiftwin`` (2r+2)^2 weight maps a tap, for every layer of the trunk
until the backward; recomputed, one layer's graph lives at a time.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import cuda

R = 2           # in-window radius of route A (floor of every offset)
HALO = R + 2    # the Pallas kernel's row/column halo (for its VMEM gate)
_ARGS = (cuda.P,) * 4 + (cuda.I,) + (cuda.P,) * 2 + (cuda.I,) * 11 \
    + (cuda.P,)
SMS = 132       # the H100's streaming multiprocessors
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
    the forward is the same and the backward is :func:`deform_conv2d_vjp`
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
    b, h, w, c = x.shape
    kh, kw, cin, co = kernel.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if (kh, kw) != (3, 3) or cin != c or offsets.shape != (b, ho, wo, 18):
        raise ValueError(f"deform_conv2d: x {tuple(x.shape)}, offsets "
                         f"{tuple(offsets.shape)}, kernel "
                         f"{tuple(kernel.shape)} do not fit a 3x3 DCN")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or offsets.dtype != x.dtype or kernel.dtype != x.dtype:
        raise TypeError("deform_conv2d: x, offsets and kernel must share "
                        "one dtype, f32 or bf16")
    for t in (x, offsets, kernel):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("deform_conv2d: inputs must be contiguous, on "
                             "one device")
    if x.numel() >= 2 ** 31 or b * ho * wo * max(co, 18) >= 2 ** 31:
        raise ValueError("deform_conv2d: tensors too large for int32 "
                         "indexing")
    out = _launch(x, offsets, kernel, stride, dilation,
                  tap_splits(b * ho * wo, co))
    deform_conv2d.launches += 1
    return out


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
    inputs: route B's under ``pallas`` and ``patch``
    (``siammot_tpu/ops/deform_conv.py:_pallas_guarded_bwd``), each other
    form's own.  Saves only the inputs."""

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
        grads = deform_conv2d_vjp(x, offsets, kernel, grad, *ctx.geometry,
                                  need=need, impl=ctx.impl)
        return (*grads, None, None, None)


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
        cy_abs = gy.to(oy.dtype) + oy
        cx_abs = gx.to(ox.dtype) + ox
        fly, flx = torch.floor(cy_abs), torch.floor(cx_abs)
        fy, fx = (cy_abs - fly).to(dt), (cx_abs - flx).to(dt)
        y0, x0 = fly.long(), flx.long()
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
