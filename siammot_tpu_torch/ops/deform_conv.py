"""Kernel 9: the deformable convolution (DCNv1) forward.

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
"""

from __future__ import annotations

import torch

from . import cuda

R = 2           # in-window radius of route A (floor of every offset)
HALO = R + 2    # the Pallas kernel's row/column halo (for its VMEM gate)
_ARGS = (cuda.P,) * 4 + (cuda.I,) + (cuda.P,) * 2 + (cuda.I,) * 11 \
    + (cuda.P,)
SMS = 132       # the H100's streaming multiprocessors


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
                  dilation: int = 1) -> torch.Tensor:
    """DCNv1 forward, NHWC.

    x [B, H, W, C]; offsets [B, Ho, Wo, 18] tap-major (dy, dx) pairs in
    x's dtype; kernel [3, 3, C, Co] HWIO in x's dtype; padding = dilation.
    Returns [B, Ho, Wo, Co] in x's dtype.  CUDA tensors launch the kernel
    (f32 or bf16); CPU tensors take :func:`deform_conv2d_plain`.
    """
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, kernel, stride, dilation)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, offsets, kernel)):
        raise NotImplementedError("deform_conv2d: the kernel is forward "
                                  "only; training a DCN body is not ported")
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


def _taps(b, ho, wo, stride, dilation, device):
    """Integer base coordinates [1, Ho, 1, 9] and [1, 1, Wo, 9] of the
    nine taps (tap-major: row t // 3, column t % 3)."""
    t = torch.arange(9, device=device)
    gy = (torch.arange(ho, device=device)[:, None] * stride - dilation
          + (t // 3)[None] * dilation)
    gx = (torch.arange(wo, device=device)[:, None] * stride - dilation
          + (t % 3)[None] * dilation)
    return gy[None, :, None, :], gx[None, None, :, :]


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
    flat = x.reshape(b, h * w, c).float()

    def corner(dy, dx):
        yi, xi = y0 + dy, x0 + dx
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v.reshape(b, ho, wo, 9, c) * ok[..., None]

    if route_a:
        part = [cx[0][..., None] * corner(r, 0)
                + cx[1][..., None] * corner(r, 1) for r in (0, 1)]
        s = cy[0][..., None] * part[0] + cy[1][..., None] * part[1]
    else:
        s = 0
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (wy[dy] * wx[dx]).float()
                s = s + wgt[..., None] * corner(dy, dx)
    return s.to(dt)


def deform_conv2d_plain(x, offsets, kernel, stride: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version: the route decision, the exact 2x2 gather of
    every sample in the route's arithmetic, and one [N, 9C] @ [9C, Co]
    product with f32 sums, rounded once to x's dtype."""
    b = x.shape[0]
    c, co = kernel.shape[2], kernel.shape[3]
    route_a = window_route_possible(x.shape, kernel.shape, stride, dilation,
                                    x.element_size()) \
        and bool(in_window(offsets))
    s = sample_plain(x, offsets, stride, dilation, route_a)
    _, ho, wo = s.shape[:3]
    out = s.reshape(-1, 9 * c).float() @ kernel.reshape(9 * c, co).float()
    return out.to(x.dtype).reshape(b, ho, wo, co)
