"""Kernel 1: the windowed ROIAlign pool.

Replaces ``siammot_tpu/ops/pallas/window_pool.py:window_pool_pallas``
(``_kernel``), in its compacted (``valid``) form.  Each ROI reads the
``window x window`` block of the stacked level table at its origin and
contracts it with its dense interpolation weights, x then y, in f32.

On the H100 the pool is bound by bytes: a weight row has at most
2 * sampling_ratio non-zero taps, so the CUDA kernel
(``cuda/window_pool.cu``) reads only the taps inside each row's non-zero
span and does a few multiply-adds per output.  A dead ROI writes zeros
and reads nothing; outputs stay in slot order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

_ARGS = (cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.P, cuda.P, cuda.P,
         cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.P)


def window_pool(table: torch.Tensor, origins: torch.Tensor, wy: torch.Tensor,
                wx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pool ``[N, S, S, C]`` f32 from table ``[R, Wmax, C]`` (bf16/f32).

    origins [N, 2] int32 (row, col); wy/wx [N, S, window] f32 with the bin
    average folded in; valid [N] bool (dead rows give zeros).  CUDA
    tensors launch the kernel; CPU tensors take :func:`window_pool_plain`.
    """
    if table.device.type == "cpu":
        return window_pool_plain(table, origins, wy, wx, valid)
    n, s, win = wy.shape
    r, wmax, c = table.shape
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"window_pool: table dtype {table.dtype}")
    if origins.dtype != torch.int32 or valid.dtype != torch.bool \
            or wy.dtype != torch.float32 or wx.dtype != torch.float32:
        raise TypeError("window_pool: origins int32, valid bool, wy/wx f32")
    if wx.shape != wy.shape or origins.shape != (n, 2) \
            or valid.shape != (n,):
        raise ValueError("window_pool: inconsistent shapes")
    for t in (table, origins, wy, wx, valid):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError("window_pool: inputs must be contiguous, on "
                             "the table's device")
    out = torch.empty((n, s, s, c), dtype=torch.float32, device=table.device)
    fn = cuda.function("siammot_window_pool", _ARGS)
    cuda.check("window_pool", fn(
        cuda.ptr(table), int(table.dtype == torch.bfloat16), r, wmax, c,
        cuda.ptr(origins), cuda.ptr(wy), cuda.ptr(wx), cuda.ptr(valid),
        cuda.ptr(out), n, s, win, cuda.stream(table.device)))
    window_pool.launches += 1
    return out


window_pool.launches = 0


def window_pool_plain(table, origins, wy, wx, valid):
    """Plain PyTorch version: dense window gather and two contractions
    (x first, then y), f32, 16 ROIs at a time to bound the gathered
    windows' memory.  The table is padded by one window so every window
    slice is in bounds, as the JAX package pads it."""
    chunk = 16
    n, s, win = wy.shape
    c = table.shape[-1]
    t = F.pad(table, (0, 0, 0, max(0, win - table.shape[1]), 0, win))
    ar = torch.arange(win, device=table.device)
    wy = torch.where(valid[:, None, None], wy, torch.zeros_like(wy))
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
