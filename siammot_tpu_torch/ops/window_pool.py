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
(``cuda/window_pool_bwd.cu``) is a deterministic gather: a first pass
finds each ROI's non-zero weight spans and the table rectangle it touches,
a second the bit masks of the ROIs that meet each band of 8 table rows and
each span of 8 columns, and the gather takes a block per 8 x 8 table tile,
walks the AND of its two masks in ROI order, stages each ROI's block of
``g`` and weights in shared memory (double-buffered ``cp.async``) and adds
its ``sum_j wx * (sum_i wy * g)`` (rows first, then columns, as the Pallas
kernel's two stages) to registers; every table element is written once,
zeros included, with no atomics, so the gradient is bitwise the same from
run to run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

_ARGS = (cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.P, cuda.P, cuda.P,
         cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.P)
_BWD_ARGS = (cuda.P,) * 7 + (cuda.I,) * 6 + (cuda.P,)


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
    cuda.check_extent("window_pool", table, origins, wy, wx, (n, s, s, c))
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
    (dead rows of ``valid`` add nothing), each table element summing its
    ROIs in ROI order, bitwise the same from run to run.  CUDA tensors
    launch the kernel; CPU tensors take :func:`window_pool_bwd_plain`."""
    if grad.device.type == "cpu":
        return window_pool_bwd_plain(grad, origins, wy, wx, table_shape,
                                     valid)
    r, wmax, c = table_shape
    n, s, win = wy.shape
    if grad.dtype != torch.float32 or grad.shape != (n, s, s, c):
        raise TypeError(f"window_pool_bwd: grad must be [N, S, S, C] f32, "
                        f"got {tuple(grad.shape)} {grad.dtype}")
    _check_geometry("window_pool_bwd", grad, origins, wy, wx, valid)
    # written once by the kernel, zeros included
    dtable = torch.empty(table_shape, dtype=torch.float32,
                         device=grad.device)
    words = cuda.function("siammot_window_pool_bwd_scratch",
                          (cuda.I,) * 4)(n, win, r, wmax)
    scratch = torch.empty(words, dtype=torch.int32, device=grad.device)
    fn = cuda.function("siammot_window_pool_bwd", _BWD_ARGS)
    cuda.check("window_pool_bwd", fn(
        cuda.ptr(grad), cuda.ptr(origins), cuda.ptr(wy), cuda.ptr(wx),
        None if valid is None else cuda.ptr(valid), cuda.ptr(dtable),
        cuda.ptr(scratch), r, wmax, c, n, s, win,
        cuda.stream(grad.device)))
    window_pool_bwd.launches += 1
    return dtable


window_pool_bwd.launches = 0


# kernel 7's table tiles (rows, columns): ``cuda/window_pool_bwd.cu`` TR, TC
BWD_TILE = (8, 8)


def touched_rects(origins, wy, wx, table_shape, valid=None):
    """Plain version of kernel 7's first pass: the table rectangle each
    ROI's non-zero taps touch, [N, 4] int64 (first row, last row, first
    column, last column); first > last for a ROI that touches nothing (dead
    in ``valid``, or every tap outside the table)."""
    r, wmax, _ = table_shape
    n, _, win = wy.shape
    ar = torch.arange(win, device=wy.device)
    o = origins.long()
    rows = (wy != 0).any(1) & (o[:, :1] + ar >= 0) & (o[:, :1] + ar < r)
    cols = (wx != 0).any(1) & (o[:, 1:] + ar >= 0) & (o[:, 1:] + ar < wmax)
    if valid is not None:
        rows &= valid[:, None]
    live = rows.any(1) & cols.any(1)

    def extent(m, base):
        first = torch.where(m, ar, win).amin(1)
        last = torch.where(m, ar, -1).amax(1)
        return base + first, base + last

    y0, y1 = extent(rows, o[:, 0])
    x0, x1 = extent(cols, o[:, 1])
    empty = torch.tensor([1, 0, 1, 0], device=wy.device)
    return torch.where(live[:, None], torch.stack([y0, y1, x0, x1], 1),
                       empty)


def tile_counts(rects, table_shape, tile=BWD_TILE):
    """The number of ROIs kernel 7's gather visits at each table tile (its
    rectangle meets the tile), [ceil(R / rows), ceil(Wmax / columns)]."""
    r, wmax, _ = table_shape
    tr, tc = tile
    bands = torch.arange(0, r, tr, device=rects.device)
    spans = torch.arange(0, wmax, tc, device=rects.device)
    live = rects[:, 0] <= rects[:, 1]
    in_band = live[:, None] & (rects[:, :1] <= bands + tr - 1) \
        & (rects[:, 1:2] >= bands)
    in_cols = (rects[:, 2:3] <= spans + tc - 1) & (rects[:, 3:4] >= spans)
    return (in_band.float().T @ in_cols.float()).round().long()


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
