"""Kernels 1 and 7: the windowed ROIAlign pool and its table gradient.

Kernel 1 replaces ``siammot_tpu/ops/pallas/window_pool.py:window_pool_pallas``
(``_kernel``), in its compacted (``valid``) form at inference and with
every ROI live in training.  Kernel 7 replaces
``window_pool_pallas_bwd`` (``_bwd_kernel``), the backward of the
training pool (table gradient only, as ``_window_pool_bwd`` returns zeros
for the origins and weights).  Each ROI reads the
``window x window`` block of the stacked level table at its origin and
contracts it with its dense interpolation weights, x then y, in f32.

On the H100 the pool is bound by bytes: a weight row has at most
2 * sampling_ratio non-zero taps.  The CUDA kernel
(``cuda/window_pool.cu:window_pool_band``) takes one block per (ROI, band
of 4 output rows, channel tile), finds each weight row's non-zero span in
parallel, and streams the table rows its band covers, each row segment
read once with ``cp.async``, several rows a chunk, double-buffered; each
thread forms ``sum_x wx * t`` once per row and adds it into its band's
accumulators (separable sums, the same products in the same order as a
direct loop).  A dead ROI writes zeros and reads nothing; outputs stay in
slot order.  The backward kernel
(``cuda/window_pool_bwd.cu``) forms each ROI's ``Wy^T G Wx`` over the
same non-zero spans and adds every touched table element once, with an
f32 atomic (the windows of training ROIs overlap).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

_ARGS = (cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.P, cuda.P, cuda.P,
         cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.P)
_BWD_ARGS = (cuda.P,) * 6 + (cuda.I,) * 6 + (cuda.P,)


def window_pool(table: torch.Tensor, origins: torch.Tensor, wy: torch.Tensor,
                wx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pool ``[N, S, S, C]`` f32 from table ``[R, Wmax, C]`` (bf16/f32).

    origins [N, 2] int32 (row, col); wy/wx [N, S, window] f32 with the bin
    average folded in; valid [N] bool (dead rows give zeros) or None (all
    live).  CUDA tensors launch the kernel; CPU tensors take
    :func:`window_pool_plain`.
    """
    if table.device.type == "cpu":
        return window_pool_plain(table, origins, wy, wx, valid)
    n, s, win = wy.shape
    r, wmax, c = table.shape
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"window_pool: table dtype {table.dtype}")
    _check_geometry("window_pool", table, origins, wy, wx, valid)
    out = torch.empty((n, s, s, c), dtype=torch.float32, device=table.device)
    fn = cuda.function("siammot_window_pool", _ARGS)
    cuda.check("window_pool", fn(
        cuda.ptr(table), int(table.dtype == torch.bfloat16), r, wmax, c,
        cuda.ptr(origins), cuda.ptr(wy), cuda.ptr(wx),
        None if valid is None else cuda.ptr(valid),
        cuda.ptr(out), n, s, win, cuda.stream(table.device)))
    window_pool.launches += 1
    return out


window_pool.launches = 0


def _check_geometry(what, table, origins, wy, wx, valid):
    n = wy.shape[0]
    if origins.dtype != torch.int32 or wy.dtype != torch.float32 \
            or wx.dtype != torch.float32 \
            or (valid is not None and valid.dtype != torch.bool):
        raise TypeError(f"{what}: origins int32, valid bool, wy/wx f32")
    if wx.shape != wy.shape or origins.shape != (n, 2) \
            or (valid is not None and valid.shape != (n,)):
        raise ValueError(f"{what}: inconsistent shapes")
    for t in (table, origins, wy, wx) + (() if valid is None else (valid,)):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous, on the "
                             "table's device")


def window_pool_bwd(grad: torch.Tensor, origins: torch.Tensor,
                    wy: torch.Tensor, wx: torch.Tensor, table_shape,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 7: the table gradient ``dtable [R, Wmax, C]`` f32 of
    :func:`window_pool` for the upstream gradient ``grad [N, S, S, C]``
    (dead rows of ``valid`` add nothing).  CUDA tensors launch the kernel
    on a zeroed table; CPU tensors take :func:`window_pool_bwd_plain`."""
    if grad.device.type == "cpu":
        return window_pool_bwd_plain(grad, origins, wy, wx, table_shape,
                                     valid)
    r, wmax, c = table_shape
    n, s, win = wy.shape
    if grad.dtype != torch.float32 or grad.shape != (n, s, s, c):
        raise TypeError(f"window_pool_bwd: grad must be [N, S, S, C] f32, "
                        f"got {tuple(grad.shape)} {grad.dtype}")
    dtable = torch.zeros(table_shape, dtype=torch.float32,
                         device=grad.device)
    _check_geometry("window_pool_bwd", grad, origins, wy, wx, valid)
    fn = cuda.function("siammot_window_pool_bwd", _BWD_ARGS)
    cuda.check("window_pool_bwd", fn(
        cuda.ptr(grad), cuda.ptr(origins), cuda.ptr(wy), cuda.ptr(wx),
        None if valid is None else cuda.ptr(valid), cuda.ptr(dtable),
        r, wmax, c, n, s, win, cuda.stream(grad.device)))
    window_pool_bwd.launches += 1
    return dtable


window_pool_bwd.launches = 0


class _WindowPool(torch.autograd.Function):
    """Kernel 1 over live ROIs, kernel 7 as its backward.  The gradient
    covers the table only: the origins and weights get none, as the JAX
    VJP gives them zeros."""

    @staticmethod
    def forward(ctx, table, origins, wy, wx):
        ctx.save_for_backward(origins, wy, wx)
        ctx.table_shape = tuple(table.shape)
        return window_pool(table, origins, wy, wx, None)

    @staticmethod
    def backward(ctx, grad):
        origins, wy, wx = ctx.saved_tensors
        dtable = window_pool_bwd(grad.contiguous(), origins, wy, wx,
                                 ctx.table_shape)
        return dtable, None, None, None


def window_pool_train(table: torch.Tensor, origins: torch.Tensor,
                      wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Differentiable pool of every ROI (the training pool sites).  The
    table must be f32: its gradient accumulates in f32, as the JAX
    training step packs an f32 table."""
    if table.dtype != torch.float32:
        raise TypeError(f"the differentiable pool needs an f32 table, got "
                        f"{table.dtype}")
    return _WindowPool.apply(table, origins, wy, wx)


def window_pool_plain(table, origins, wy, wx, valid):
    """Plain PyTorch version: dense window gather and two contractions
    (x first, then y), f32, 16 ROIs at a time to bound the gathered
    windows' memory.  The table is padded by one window so every window
    slice is in bounds, as the JAX package pads it.  With ``valid``, only
    the live rows are pooled and dead rows are zeros."""
    if valid is not None:
        live = valid.nonzero()[:, 0]
        part = window_pool_plain(table, origins[live], wy[live], wx[live],
                                 None)
        out = part.new_zeros((wy.shape[0],) + part.shape[1:])
        out[live] = part
        return out
    chunk = 16
    n, s, win = wy.shape
    c = table.shape[-1]
    t = F.pad(table, (0, 0, 0, max(0, win - table.shape[1]), 0, win))
    ar = torch.arange(win, device=table.device)
    out = []
    for i in range(0, n, chunk):
        o = origins[i:i + chunk].long()
        rows = o[:, 0, None] + ar
        cols = o[:, 1, None] + ar
        windows = t[rows[:, :, None], cols[:, None, :]].float()
        tmp = torch.einsum("ntw,nhwc->nhtc", wx[i:i + chunk], windows)
        out.append(torch.einsum("nsh,nhtc->nstc", wy[i:i + chunk], tmp))
    if not out:
        return torch.zeros((0, s, s, c), dtype=torch.float32,
                           device=table.device)
    return torch.cat(out)


def window_pool_bwd_plain(grad, origins, wy, wx, table_shape, valid=None):
    """Plain version of the table gradient: autograd through
    :func:`window_pool_plain` on a zero f32 table of ``table_shape``."""
    with torch.enable_grad():
        table = torch.zeros(table_shape, dtype=torch.float32,
                            device=grad.device, requires_grad=True)
        out = window_pool_plain(table, origins, wy, wx, valid)
        return torch.autograd.grad(out, table, grad)[0]
