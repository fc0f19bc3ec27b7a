"""Windowed-separable ROIAlign (port of
``siammot_tpu.ops.roi_align_windowed``).

maskrcnn ROIAlign semantics (``aligned=False``, virtual padding), written
as two dense interpolation matrices per ROI over a static window of one
stacked table that holds every FPN level.  This module computes the
window origins and the weights in plain PyTorch, exactly as the JAX
prologue does (8-aligned column origins, the clamp into the level, the
bin average folded into the weights); the pool itself is kernel 1
(``ops/window_pool.py``), which reads these same tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .window_pool import window_pool


@dataclasses.dataclass
class LevelPack:
    """Stacked FPN levels ready for windowed pooling."""

    table: torch.Tensor        # [R, Wmax, C]
    row_offsets: torch.Tensor  # [B * L] int32 block start rows
    heights: torch.Tensor      # [L] int32
    widths: torch.Tensor       # [L] int32
    scales: tuple
    num_levels: int


def stack_levels(features: list):
    """Stack per-level [B, Hi, Wi, C] maps into one row table.

    Returns (table [R, Wmax, C], row_offsets [B*L], heights [L],
    widths [L]); the block of (image b, level l) starts at row
    ``row_offsets[b * L + l]``.
    """
    b = features[0].shape[0]
    wmax = max(f.shape[2] for f in features)
    blocks, offsets, row = [], [], 0
    for bi in range(b):
        for f in features:
            blocks.append(F.pad(f[bi], (0, 0, 0, wmax - f.shape[2])))
            offsets.append(row)
            row += f.shape[1]
    heights = np.array([f.shape[1] for f in features], np.int32)
    widths = np.array([f.shape[2] for f in features], np.int32)
    return torch.cat(blocks), np.array(offsets, np.int32), heights, widths


def pack_levels(features: list, scales: tuple, dtype=None) -> LevelPack:
    """LevelPack from per-level NHWC maps (one copy, cast to ``dtype``)."""
    table, offsets, heights, widths = stack_levels(features)
    if dtype is not None:
        table = table.to(dtype)
    dev = table.device
    return LevelPack(table=table.contiguous(),
                     row_offsets=torch.as_tensor(offsets, device=dev),
                     heights=torch.as_tensor(heights, device=dev),
                     widths=torch.as_tensor(widths, device=dev),
                     scales=tuple(scales), num_levels=len(features))


def _sample_positions(start, roi_extent, out_size: int, sampling_ratio: int):
    """All 1-D sample coordinates for one axis -> [..., out*S]."""
    bin_size = roi_extent / out_size
    s = torch.arange(out_size * sampling_ratio, dtype=torch.float32,
                     device=start.device)
    frac = (s + 0.5) / sampling_ratio
    return start[..., None] + frac * bin_size[..., None]


def _axis_weights(pos, size_real, pad, origin, window: int):
    """Dense per-ROI interpolation weights along one axis, [N, S, window],
    with maskrcnn's boundary rules and the virtual pad baked in."""
    padded = size_real + 2 * pad                         # [N] int32
    size_padded = padded.to(pos.dtype)[:, None]
    inside = (pos >= -1.0) & (pos <= size_padded)
    p = torch.minimum(pos.clamp(min=0.0), size_padded - 1)
    lo = torch.minimum(torch.floor(p).to(torch.int32), padded[:, None] - 1)
    hi = torch.minimum(lo + 1, padded[:, None] - 1)
    at_edge = lo >= padded[:, None] - 1
    frac = torch.where(at_edge, torch.zeros_like(p), p - lo.to(p.dtype))

    def rel(idx):
        real = idx - pad[:, None]
        ok = (real >= 0) & (real < size_real[:, None])
        return real - origin[:, None], ok

    lo_r, lo_ok = rel(lo)
    hi_r, hi_ok = rel(hi)
    zero = torch.zeros_like(frac)
    w_lo = torch.where(inside & lo_ok, 1.0 - frac, zero)
    w_hi = torch.where(inside & hi_ok, frac, zero)
    cols = torch.arange(window, dtype=torch.int32, device=pos.device)
    return (w_lo[..., None] * (lo_r[..., None] == cols).to(pos.dtype)
            + w_hi[..., None] * (hi_r[..., None] == cols).to(pos.dtype))


def window_geometry(heights, widths, row_offsets, rois, block_idx, scales,
                    output_size: int, sampling_ratio: int, window: int,
                    pad_pixels: int, num_levels: int):
    """Origins [N, 2] int32 and weights wy, wx [N, S, window] f32."""
    level = (block_idx % num_levels).long()
    h_arr = heights[level]
    w_arr = widths[level]
    pads = torch.round(pad_pixels * scales).to(torch.int32)
    row0 = row_offsets[block_idx.long()]

    start = rois[:, :2] * scales[:, None]
    end = rois[:, 2:] * scales[:, None]
    extent = (end - start).clamp(min=1.0)
    xs = _sample_positions(start[:, 0], extent[:, 0], output_size,
                           sampling_ratio)
    ys = _sample_positions(start[:, 1], extent[:, 1], output_size,
                           sampling_ratio)

    # window origin: centre the sample span, clamped into the level
    def origin(pos, pad, size):
        first = torch.floor(pos[:, 0]).to(torch.int32) - pad
        last = torch.floor(pos[:, -1]).to(torch.int32) + 1 - pad
        o = first - torch.div(window - (last - first + 1), 2,
                              rounding_mode="floor").clamp(min=0)
        return torch.minimum(o.clamp(min=0), (size - window).clamp(min=0))

    oy = origin(ys, pads, h_arr)
    # 8-aligned column origins, as the TPU kernel needs and the JAX
    # prologue computes; kept so both packages pool the same windows
    ox = torch.div(origin(xs, pads, w_arr), 8, rounding_mode="floor") * 8

    wy = _axis_weights(ys, h_arr, pads, oy, window)
    wx = _axis_weights(xs, w_arr, pads, ox, window)
    # fold the r x r bin average into the weights (linearity)
    if sampling_ratio > 1:
        n = rois.shape[0]
        wy = wy.reshape(n, output_size, sampling_ratio, window).mean(dim=2)
        wx = wx.reshape(n, output_size, sampling_ratio, window).mean(dim=2)
    origins = torch.stack([row0 + oy, ox], dim=-1).to(torch.int32)
    return origins.contiguous(), wy.contiguous(), wx.contiguous()


def roi_align_windowed(table, row_offsets, heights, widths, rois, block_idx,
                       scales, output_size: int, sampling_ratio: int,
                       window: int, pad_pixels: int, num_levels: int,
                       valid):
    """ROIAlign over a stacked level table -> [N, out, out, C] f32.

    rois [N, 4] xyxy (padded coords if pad_pixels > 0); block_idx [N] =
    img_idx * num_levels + level; scales [N] spatial scale per ROI;
    valid [N] bool (dead rows pool to zeros).
    """
    origins, wy, wx = window_geometry(heights, widths, row_offsets, rois,
                                      block_idx, scales, output_size,
                                      sampling_ratio, window, pad_pixels,
                                      num_levels)
    return window_pool(table, origins, wy, wx, valid.contiguous())


def windowed_pool(pack: LevelPack, rois, img_idx, levels, output_size: int,
                  sampling_ratio: int, window: int, pad_pixels: int = 0,
                  *, valid):
    """FPN pooling of ``rois`` over a LevelPack (the inference pooler)."""
    scales = torch.as_tensor(np.array(pack.scales, np.float32),
                             device=rois.device)[levels.long()]
    return roi_align_windowed(
        pack.table, pack.row_offsets, pack.heights, pack.widths, rois,
        img_idx * pack.num_levels + levels, scales, output_size,
        sampling_ratio, window, pad_pixels, pack.num_levels, valid=valid)
