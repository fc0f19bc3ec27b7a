"""The exact gather ROIAlign (port of ``siammot_tpu.ops.roi_align``).

maskrcnn ROIAlign over NHWC FPN maps, as the JAX package's XLA gather
pooler computes it: ``aligned=False`` (``start = x1 * scale``, extent
``max(end - start, 1)``), ``r x r`` samples a bin at ``(s + 0.5) / r``,
samples outside ``[-1, size]`` weigh 0, the rest clamped into
``[0, size - 1]``, and the virtual pad (``round(PAD_PIXELS * scale)``
feature pixels a level) whose taps read 0.  Every level of every image
is one row table ``[T, C]`` (:class:`LevelTable`, image-major as JAX's
``multilevel_roi_align_batched`` flattens them), and each ROI names its
block of it by a geometry row (first row, height, width, pad) and its
scale.

The pool runs in the maps' dtype and rounds as the JAX gather does
(``cuda/roi_align.cu`` says how).  On CUDA tensors the forward and its
backward are hand-written kernels (``cuda/roi_align.cu``:
``roi_align_fwd``, ``roi_align_bwd``); on CPU tensors the plain forms
below, the JAX gather transcribed.  The gradient flows to the maps only
(proposals are data, ``siammot_tpu/models/siammot.py:471-477``): each
table element sums ``g / r^2`` times each tap's weight in f32; the kernel
sums in a fixed order (:func:`roi_align_bwd_ordered`) and writes the
table in the maps' dtype, the plain form with ``index_add_`` into an f32
table.  The JAX package leaves this pooler to XLA, so these kernels
replace no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import cuda
from ..core.boxes import map_rois_to_levels  # noqa: F401 (the level mapper)
from .roi_align_windowed import LevelPack, windowed_pool

# elements of one gathered corner tensor a chunk of the plain forms
PLAIN_CHUNK = 1 << 24


@dataclasses.dataclass
class LevelTable:
    """Per-level NHWC maps of B images as one row table."""

    table: torch.Tensor        # [T, C] in the maps' dtype
    offsets: torch.Tensor      # [B * L] int32: block (b, l) starts there
    heights: torch.Tensor      # [L] int32
    widths: torch.Tensor       # [L] int32
    scales: tuple
    num_levels: int
    layout: tuple              # ((height, width) of each block, in order)

    @property
    def images(self) -> int:
        return self.offsets.shape[0] // self.num_levels

    def geometry(self, img_idx, levels, pad_pixels: int = 0):
        """Per ROI: (geometry [N, 4] int32 of first row, height, width,
        pad; scale [N] f32)."""
        if img_idx is None:
            if self.images != 1:
                raise ValueError(f"roi_align: a table of {self.images} "
                                 f"images needs each ROI's image index")
            img_idx = torch.zeros_like(levels)
        lv = levels.long()
        pads, scales = _level_constants(self.scales, pad_pixels,
                                        str(self.table.device))
        geom = torch.stack([
            self.offsets[img_idx.long() * self.num_levels + lv],
            self.heights[lv], self.widths[lv], pads[lv]],
            1).to(torch.int32).contiguous()
        return geom, scales[lv].contiguous()

    def pool(self, rois, img_idx, levels, output_size: int,
             sampling_ratio: int, pad_pixels: int = 0, valid=None):
        """Pool ``rois`` [N, 4] (padded coordinates where ``pad_pixels``),
        each from its image ``img_idx`` [N] (None: a one-image table) at
        level ``levels`` [N] -> [N, o, o, C] in the table's dtype; rows
        not ``valid`` are zeros.  Differentiable in the table where it
        needs a gradient."""
        geom, scale = self.geometry(img_idx, levels, pad_pixels)
        return roi_align_rows(self.table, rois.float().contiguous(), geom,
                              scale, output_size, sampling_ratio, valid,
                              self.layout)


@functools.lru_cache(maxsize=16)
def _level_constants(scales: tuple, pad_pixels: int, device: str):
    """Each level's virtual pad, ``round(PAD_PIXELS * scale)`` as Python
    rounds (half to even, as ``jnp.round``), and its scale."""
    return (torch.tensor([round(pad_pixels * s) for s in scales],
                         dtype=torch.int32, device=device),
            torch.tensor(scales, dtype=torch.float32, device=device))


def level_table(features: list, scales: tuple) -> LevelTable:
    """The :class:`LevelTable` of per-level ``[B, Hi, Wi, C]`` maps.  Only
    the levels the scales cover are kept (a P6 map has no pooler scale,
    ``siammot_tpu/ops/roi_align.py:160-163``).  One concatenation, in the
    maps' dtype, differentiable.  Image-major: the levels of image 0,
    then of image 1, ...; one concatenation along the rows of each image,
    whose backward hands each map a view of the table's gradient."""
    features = list(features)[:len(scales)]
    b, c = features[0].shape[0], features[0].shape[-1]
    table = torch.cat([f.reshape(b, -1, c) for f in features],
                      1).reshape(-1, c)
    sizes = tuple((f.shape[1], f.shape[2]) for f in features)
    offsets, heights, widths = _layout(sizes, b, str(table.device))
    return LevelTable(table=table, offsets=offsets, heights=heights,
                      widths=widths, scales=tuple(scales),
                      num_levels=len(features), layout=sizes * b)


@functools.lru_cache(maxsize=16)
def _layout(sizes: tuple, b: int, device: str):
    hw = np.array([h * w for h, w in sizes] * b, np.int64)
    offsets = np.concatenate([[0], np.cumsum(hw)])[:-1]
    to = functools.partial(torch.tensor, dtype=torch.int32, device=device)
    return (to(offsets), to([h for h, _ in sizes]),
            to([w for _, w in sizes]))


def pool_rois(src, rois, img_idx, levels, output_size: int,
              sampling_ratio: int, window: int, pad_pixels: int = 0, *,
              valid):
    """One pool site over either route: the exact gather pooler on a
    :class:`LevelTable`, or the windowed pool (kernel 1) on a
    ``LevelPack`` with the site's ``window``.  ``valid=None``: every row
    live and, in training, differentiable."""
    if isinstance(src, LevelPack):
        return windowed_pool(src, rois, img_idx, levels, output_size,
                             sampling_ratio, window, pad_pixels, valid=valid)
    return src.pool(rois, img_idx, levels, output_size, sampling_ratio,
                    pad_pixels, valid)


# -- the JAX package's functions ---------------------------------------------

def roi_align(features, rois, output_size: int, spatial_scale: float,
              sampling_ratio: int, pad: int = 0):
    """Single-level ROIAlign of one image's [H, W, C] map; ``pad`` in
    feature pixels (``siammot_tpu/ops/roi_align.py:roi_align``)."""
    h, w, c = features.shape
    n = rois.shape[0]
    dev = features.device
    geom = torch.tensor([[0, h, w, pad]], dtype=torch.int32,
                        device=dev).expand(n, 4).contiguous()
    scale = torch.full((n,), spatial_scale, dtype=torch.float32, device=dev)
    return roi_align_rows(features.reshape(h * w, c),
                          rois.float().contiguous(), geom, scale,
                          output_size, sampling_ratio, None, ((h, w),))


def multilevel_roi_align(features: list, rois, levels, output_size: int,
                         scales: tuple, sampling_ratio: int,
                         pad_pixels: int = 0):
    """FPN pooler of one image: ``features`` [Hi, Wi, C] per level, each
    ROI from its level ``levels`` [N]."""
    return level_table([f[None] for f in features], scales).pool(
        rois, None, levels, output_size, sampling_ratio, pad_pixels)


def multilevel_roi_align_batched(features: list, rois, img_idx, levels,
                                 output_size: int, scales: tuple,
                                 sampling_ratio: int, pad_pixels: int = 0,
                                 valid=None):
    """FPN pooler over B images: ``features`` [B, Hi, Wi, C] per level
    (levels past ``len(scales)`` dropped), each ROI from its (image,
    level) pair; rows not ``valid`` are zeros."""
    return level_table(features, scales).pool(
        rois, img_idx, levels, output_size, sampling_ratio, pad_pixels,
        valid)


# -- the pool over a row table: kernels, plain forms, gradient --------------

def roi_align_rows(table, rois, geom, scale, output_size: int,
                   sampling_ratio: int, valid, layout):
    """ROIAlign over a row table [T, C]: rois [N, 4] f32, geom [N, 4]
    int32 (first row, height, width, pad), scale [N] f32, valid [N] bool or
    None -> [N, o, o, C] in the table's dtype.  Through the autograd
    Function where the table needs a gradient (every row live), whose
    backward tiles the table by ``layout`` (its blocks,
    :func:`roi_align_bwd`)."""
    if valid is None and table.requires_grad and torch.is_grad_enabled():
        return _RoiAlign.apply(table, rois, geom, scale, output_size,
                               sampling_ratio, layout)
    return roi_align_fwd(table, rois, geom, scale, output_size,
                         sampling_ratio, valid)


class _RoiAlign(torch.autograd.Function):
    """The forward kernel (or plain form) and the backward kernel, which
    writes the table's gradient in the table's dtype; no gradient for the
    ROIs or geometry."""

    @staticmethod
    def forward(ctx, table, rois, geom, scale, output_size, sampling_ratio,
                layout):
        ctx.save_for_backward(rois, geom, scale)
        ctx.meta = (tuple(table.shape), output_size, sampling_ratio, layout)
        return roi_align_fwd(table, rois, geom, scale, output_size,
                             sampling_ratio, None)

    @staticmethod
    def backward(ctx, grad):
        rois, geom, scale = ctx.saved_tensors
        shape, o, r, layout = ctx.meta
        dtable = roi_align_bwd(grad.contiguous(), rois, geom, scale, shape,
                               o, r, layout)
        return dtable, None, None, None, None, None, None


_FWD_ARGS = (cuda.P, cuda.I, cuda.I, cuda.P, cuda.P, cuda.P, cuda.P,
             cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.P)
_BWD_ARGS = (cuda.P, cuda.I, cuda.I, cuda.I, cuda.P, cuda.P, cuda.P,
             cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
             cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P,
             cuda.P, cuda.P, cuda.P, cuda.P, cuda.I, cuda.P, cuda.I, cuda.I,
             cuda.I, cuda.P)
# the backward's table tiles: BWD_TILE x BWD_TILE cells of a level map
# (``TILE`` of ``cuda/roi_align.cu``); ROIs a call: a tile's list, 4 bytes
# a ROI in words of 32, lives in the shared memory a block may opt in to
# (227 KB) beside the gather's static arrays (``GATHER_STATIC``)
BWD_TILE = 8
BWD_STATIC_SMEM = 18436
BWD_MAX_ROIS = (227 * 1024 - BWD_STATIC_SMEM) // (32 * 4) * 32
# long tile lists (ROIs piled up on a few objects) are cut into chunks of
# ROIs summed by blocks of their own, their f32 partial sums added in
# chunk order: at most BWD_PARTS chunks a call (BWD_PARTS x BWD_TILE^2 x
# C f32 of workspace), of the least BWD_CHUNK << k ROIs that fit
# (:func:`bwd_chunk_size`)
BWD_CHUNK = 32
BWD_CHUNK_STEPS = 12
BWD_PARTS = 1024


def _check(what, table, rois, geom, scale, valid):
    n = rois.shape[0]
    if table.dtype not in (torch.bfloat16, torch.float32) \
            or table.dim() != 2:
        raise TypeError(f"{what}: table [T, C] bf16/f32, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if rois.dtype != torch.float32 or geom.dtype != torch.int32 \
            or scale.dtype != torch.float32 \
            or (valid is not None and valid.dtype != torch.bool):
        raise TypeError(f"{what}: rois/scale f32, geom int32, valid bool")
    if rois.shape != (n, 4) or geom.shape != (n, 4) \
            or scale.shape != (n,) \
            or (valid is not None and valid.shape != (n,)):
        raise ValueError(f"{what}: inconsistent shapes")
    for t in (table, rois, geom, scale) + (() if valid is None
                                           else (valid,)):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous, on the "
                             "table's device")


def roi_align_fwd(table, rois, geom, scale, output_size: int,
                  sampling_ratio: int, valid=None):
    """The pool's forward.  CUDA tensors launch ``roi_align_fwd`` of
    ``cuda/roi_align.cu``; CPU tensors take :func:`roi_align_plain`."""
    if table.device.type == "cpu":
        return roi_align_plain(table, rois, geom, scale, output_size,
                               sampling_ratio, valid)
    _check("roi_align", table, rois, geom, scale, valid)
    n, c = rois.shape[0], table.shape[1]
    o = output_size
    cuda.check_extent("roi_align", table, (n, o, o, c))
    out = torch.empty((n, o, o, c), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    order = torch.empty(n, dtype=torch.int32, device=table.device)
    fn = cuda.function("siammot_roi_align", _FWD_ARGS)
    cuda.check("roi_align", fn(
        cuda.ptr(table), int(table.dtype == torch.bfloat16), c,
        cuda.ptr(rois), cuda.ptr(geom), cuda.ptr(scale),
        None if valid is None else cuda.ptr(valid), cuda.ptr(order),
        cuda.ptr(out), n, o, sampling_ratio, cuda.stream(table.device)))
    roi_align_fwd.launches += 1
    return out


roi_align_fwd.launches = 0


@functools.lru_cache(maxsize=16)
def bwd_plan(layout: tuple):
    """The backward's tiling of a table cut into ``layout``'s blocks
    (``(height, width)`` each, in table order): an int32 array [nb, 7] of
    (first table row, height, width, first tile, tiles a row, first row
    band, first column span) for each non-empty block, and the numbers of
    tiles, row bands and column spans.  A tile is ``BWD_TILE`` rows by
    ``BWD_TILE`` columns of a block (less at its right and bottom edges);
    its ROIs are those whose taps' rectangle meets both its row band and
    its column span."""
    rows, first, tiles, bands, cols = [], 0, 0, 0, 0
    for h, w in layout:
        if h * w:
            tr, tc = -(-h // BWD_TILE), -(-w // BWD_TILE)
            rows.append((first, h, w, tiles, tc, bands, cols))
            tiles, bands, cols = tiles + tr * tc, bands + tr, cols + tc
        first += h * w
    return (np.array(rows, np.int32).reshape(-1, 7), tiles, bands, cols)


def bwd_chunk_size(lengths, parts: int) -> int:
    """The ROIs a chunk of a long tile list (``roi_bwd_chunks``): the
    least ``BWD_CHUNK << k`` (k < ``BWD_CHUNK_STEPS``) for which the
    chunks of the lists longer than it, ``lengths`` [tiles], fit in
    ``parts`` slots; the last step passes ``BWD_MAX_ROIS``, so it cuts no
    list."""
    lengths = torch.as_tensor(lengths).long()
    for k in range(BWD_CHUNK_STEPS):
        q = BWD_CHUNK << k
        long_ = lengths[lengths > q]
        if int(((long_ + q - 1) // q).sum()) <= parts:
            break
    return q


def bwd_tile_lists(rois, geom, scale, output_size: int, sampling_ratio: int,
                   layout):
    """The backward's tile lists as a plain form: ``on`` [tiles, N] bool,
    ROI k on tile t's list where t lies in the layout block its geometry
    names and the rectangle of the cells its taps reach with a non-zero
    weight meets t (``roi_bwd_taps`` and ``roi_bwd_masks``; walked in ROI
    order); and each table row's tile [T] long."""
    blocks = bwd_plan(tuple(layout))[0]
    dev = rois.device
    off, h, w = (geom[:, i].long() for i in range(3))
    big = torch.iinfo(torch.long).max
    n = rois.shape[0]
    y0, x0 = torch.full((2, n), big, device=dev)
    y1, x1 = torch.full((2, n), -1, device=dev)
    for idx, wt in _corners(rois, geom, scale, output_size, sampling_ratio):
        local = idx - off[:, None, None]
        y, x = local // w[:, None, None], local % w[:, None, None]
        live = wt != 0
        y0 = torch.minimum(y0, torch.where(live, y, big).flatten(1).amin(1))
        y1 = torch.maximum(y1, torch.where(live, y, -1).flatten(1).amax(1))
        x0 = torch.minimum(x0, torch.where(live, x, big).flatten(1).amin(1))
        x1 = torch.maximum(x1, torch.where(live, x, -1).flatten(1).amax(1))
    tile_rows, row_tile = [], []
    for first, bh, bw, tile0, tc, _, _ in blocks.tolist():
        tr = -(-bh // BWD_TILE)
        t = torch.arange(tr * tc)
        tile_rows.append(torch.stack([torch.full_like(t, first),
                                      torch.full_like(t, bh),
                                      torch.full_like(t, bw),
                                      t // tc * BWD_TILE,
                                      t % tc * BWD_TILE], 1))
        cells = torch.arange(bh * bw)
        row_tile.append(tile0 + cells // bw // BWD_TILE * tc
                        + cells % bw // BWD_TILE)
    tl = torch.cat(tile_rows).to(dev)
    on = ((off[None] == tl[:, :1]) & (h[None] == tl[:, 1:2])
          & (w[None] == tl[:, 2:3]) & (y1[None] >= tl[:, 3:4])
          & (y0[None] <= tl[:, 3:4] + BWD_TILE - 1)
          & (x1[None] >= tl[:, 4:5])
          & (x0[None] <= tl[:, 4:5] + BWD_TILE - 1))
    return on, torch.cat(row_tile).to(dev)


@functools.lru_cache(maxsize=16)
def _plan_on(layout: tuple, device: str):
    blocks, tiles, bands, cols = bwd_plan(layout)
    return torch.from_numpy(blocks).to(device), tiles, bands, cols


def roi_align_bwd(grad, rois, geom, scale, table_shape, output_size: int,
                  sampling_ratio: int, layout, dtype=None):
    """The table gradient [T, C] of the forward for the upstream ``grad``
    [N, o, o, C] (in the table's dtype), in ``dtype`` (default the
    table's; f32 gives a bf16 gradient's sums before their rounding).
    ``layout``: the table's blocks, ``(height, width)`` each in table
    order (:attr:`LevelTable.layout`), every block a ROI names among
    them.  CUDA tensors launch ``roi_align_bwd``'s kernels (a gather in a
    fixed order, long lists cut into at most ``BWD_PARTS`` chunks: bitwise
    from call to call); CPU tensors take :func:`roi_align_bwd_plain`."""
    dtype = grad.dtype if dtype is None else dtype
    if dtype not in (grad.dtype, torch.float32):
        raise TypeError(f"roi_align_bwd: writes {grad.dtype} or f32, not "
                        f"{dtype}")
    if grad.device.type == "cpu":
        return roi_align_bwd_plain(grad, rois, geom, scale, table_shape,
                                   output_size, sampling_ratio).to(dtype)
    n, o, r = rois.shape[0], output_size, sampling_ratio
    t_rows, c = table_shape
    if grad.shape != (n, o, o, c) or not grad.is_contiguous():
        raise ValueError(f"roi_align_bwd: grad must be contiguous "
                         f"[{n}, {o}, {o}, {c}], got {tuple(grad.shape)}")
    _check("roi_align_bwd", grad.reshape(-1, c), rois, geom, scale, None)
    cuda.check_extent("roi_align_bwd", grad, table_shape)
    if n > BWD_MAX_ROIS:
        raise ValueError(f"roi_align_bwd: {n} ROIs, past the {BWD_MAX_ROIS} "
                         "whose tile lists fit in a block's shared memory")
    dev = grad.device
    if n == 0:
        return torch.zeros(table_shape, dtype=dtype, device=dev)
    layout = tuple(layout)
    if sum(h * w for h, w in layout) != t_rows:
        raise ValueError(f"roi_align_bwd: the layout {layout} does not "
                         f"cover the table's {t_rows} rows")
    sh, sw = max(h for h, _ in layout), max(w for _, w in layout)
    blocks, tiles, bands, cols = _plan_on(layout, str(dev))
    os_ = o * r
    i32 = functools.partial(torch.empty, dtype=torch.int32, device=dev)
    taps, spans, rects, blk = (i32((n, 2, os_, 4)), i32((n, sh + sw)),
                               i32((n, 4)), i32(n))
    masks = i32((bands + cols, -(-n // 32)))
    parts = BWD_PARTS
    ranges = -(-tiles // 32)  # ``RANGE`` tiles a range of the planning
    lens, slot_of, part, base, plan, work = (
        i32(tiles), i32(tiles), i32((ranges, BWD_CHUNK_STEPS)), i32(ranges),
        i32(2), i32((parts, 2)))
    ws = torch.empty((parts, BWD_TILE ** 2, c), dtype=torch.float32,
                     device=dev)
    dtable = torch.empty(table_shape, dtype=dtype, device=dev)
    fn = cuda.function("siammot_roi_align_bwd", _BWD_ARGS)
    cuda.check("roi_align_bwd", fn(
        cuda.ptr(grad), int(grad.dtype == torch.bfloat16),
        int(dtype == torch.bfloat16), c, cuda.ptr(rois), cuda.ptr(geom),
        cuda.ptr(scale), cuda.ptr(blocks), blocks.shape[0], tiles, bands,
        cols, sh, sw, cuda.ptr(taps), cuda.ptr(spans), cuda.ptr(rects),
        cuda.ptr(blk), cuda.ptr(masks), cuda.ptr(lens), cuda.ptr(part),
        cuda.ptr(base), cuda.ptr(plan), cuda.ptr(slot_of), cuda.ptr(work),
        cuda.ptr(ws), parts, cuda.ptr(dtable), n, o, r, cuda.stream(dev)))
    roi_align_bwd.launches += 1
    return dtable


roi_align_bwd.launches = 0


def _div(a, n: int):
    """``a / n`` as an IEEE division on every device: PyTorch's CUDA
    division by a Python number multiplies by its rounded reciprocal,
    which moves samples by an ulp away from the kernel's and JAX's."""
    return a / torch.full_like(a, n)


def _sample_positions(start, roi_extent, out_size: int, sampling_ratio: int):
    """All 1-D sample coordinates for one axis -> [..., out*r]:
    ``start + ((s + 0.5) / r) * (extent / out)``
    (``siammot_tpu/ops/roi_align.py:_sample_positions``)."""
    bin_size = _div(roi_extent, out_size)
    s = torch.arange(out_size * sampling_ratio, dtype=torch.float32,
                     device=start.device)
    frac = _div(s + 0.5, sampling_ratio)
    return start[..., None] + frac * bin_size[..., None]


def _bilinear_1d(pos, size, pad):
    """One axis' taps with maskrcnn's edge rules in the padded space,
    shifted to the unpadded level: (lo, hi) indices clamped into the
    level and their weights (w_lo, w_hi), 0 outside ``[-1, padded size]``
    and in the pad band (``siammot_tpu/ops/roi_align.py:_bilinear_1d`` and
    ``to_real``).  pos [N, os] f32; size, pad [N] int64."""
    sp = (size + 2 * pad)[:, None]
    spf = sp.to(pos.dtype)
    inside = (pos >= -1.0) & (pos <= spf)
    p = torch.minimum(pos.clamp(min=0.0), spf - 1)
    lo = torch.minimum(torch.floor(p).long(), sp - 1)
    hi = torch.minimum(lo + 1, sp - 1)
    frac = torch.where(lo >= sp - 1, torch.zeros_like(p),
                       p - lo.to(p.dtype))

    def real(idx, w):
        r = idx - pad[:, None]
        ok = inside & (r >= 0) & (r < size[:, None])
        return (torch.minimum(r.clamp(min=0), size[:, None] - 1),
                torch.where(ok, w, torch.zeros_like(w)))

    (lo, w_lo), (hi, w_hi) = real(lo, 1.0 - frac), real(hi, frac)
    return lo, hi, w_lo, w_hi


def _corners(rois, geom, scale, output_size: int, sampling_ratio: int):
    """The four corners' table rows [n, os, os] and f32 weights, in the
    order lo-lo, lo-hi, hi-lo, hi-hi (os = o * r)."""
    off, h, w, pad = geom.long().unbind(1)
    start = rois[:, :2] * scale[:, None]
    end = rois[:, 2:] * scale[:, None]
    extent = (end - start).clamp(min=1.0)
    xs = _sample_positions(start[:, 0], extent[:, 0], output_size,
                           sampling_ratio)
    ys = _sample_positions(start[:, 1], extent[:, 1], output_size,
                           sampling_ratio)
    x_lo, x_hi, wx_lo, wx_hi = _bilinear_1d(xs, w, pad)
    y_lo, y_hi, wy_lo, wy_hi = _bilinear_1d(ys, h, pad)
    return [(off[:, None, None] + yi[:, :, None] * w[:, None, None]
             + xi[:, None, :], wy[:, :, None] * wx[:, None, :])
            for yi, wy in ((y_lo, wy_lo), (y_hi, wy_hi))
            for xi, wx in ((x_lo, wx_lo), (x_hi, wx_hi))]


def _chunk(output_size, sampling_ratio, c):
    per_roi = (output_size * sampling_ratio) ** 2 * c
    return max(1, PLAIN_CHUNK // per_roi)


def roi_align_plain(table, rois, geom, scale, output_size: int,
                    sampling_ratio: int, valid=None):
    """Plain PyTorch form: the JAX gather (four gathered corners, each
    product and sum in the table's dtype, the samples averaged by an f32
    sum rounded once), a chunk of ROIs at a time; rows not ``valid`` are
    zeros.  Differentiable through autograd."""
    n, c = rois.shape[0], table.shape[1]
    o, r = output_size, sampling_ratio
    step = _chunk(o, r, c)
    outs = []
    for i in range(0, n, step):
        acc = None
        for idx, wgt in _corners(rois[i:i + step], geom[i:i + step],
                                 scale[i:i + step], o, r):
            v = table[idx] * wgt.to(table.dtype)[..., None]
            acc = v if acc is None else acc + v
        m = acc.shape[0]
        outs.append((acc.reshape(m, o, r, o, r, c).float().sum(dim=(2, 4))
                     / (r * r)).to(table.dtype))
    out = torch.cat(outs) if outs else table.new_zeros((0, o, o, c))
    if valid is not None:
        out = torch.where(valid[:, None, None, None], out,
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device))
    return out


def roi_align_bwd_plain(grad, rois, geom, scale, table_shape,
                        output_size: int, sampling_ratio: int):
    """Plain PyTorch form of the backward: ``g / r^2`` times each tap's
    weight (rounded to ``grad``'s dtype as the forward rounds it), added
    into an f32 table with ``index_add_``."""
    n, c = rois.shape[0], table_shape[1]
    o, r = output_size, sampling_ratio
    os_ = o * r
    dtable = torch.zeros(table_shape, dtype=torch.float32,
                         device=grad.device)
    step = _chunk(o, r, c)
    ga = grad.float() / (r * r)
    for i in range(0, n, step):
        g = ga[i:i + step]
        m = g.shape[0]
        g = g[:, :, None, :, None, :].expand(m, o, r, o, r, c).reshape(
            m, os_, os_, c)
        for idx, wgt in _corners(rois[i:i + step], geom[i:i + step],
                                 scale[i:i + step], o, r):
            w = wgt.to(grad.dtype).float()
            dtable.index_add_(0, idx.reshape(-1),
                              (g * w[..., None]).reshape(-1, c))
    return dtable


def roi_align_bwd_ordered(grad, rois, geom, scale, table_shape,
                          output_size: int, sampling_ratio: int, layout,
                          dtype=None, parts=None):
    """The backward kernel's sums in its order, in plain PyTorch on any
    device: each table element adds ``(g / r^2) * w`` (``w`` the forward's
    corner weight rounded to ``grad``'s dtype) in f32, a product then a
    sum, over the ROIs that reach it in ROI order and each ROI's samples in
    order (its bins in row-major order, then each bin's r x r samples in
    row-major order); where its tile's list (:func:`bwd_tile_lists`) is
    cut into chunks (:func:`bwd_chunk_size` of ``parts`` slots, default
    ``BWD_PARTS``), each chunk's ROIs summed from zero and the chunks'
    sums added in chunk order; rounded once to ``dtype`` (default
    ``grad``'s).  One step a term's rank in its sum: for small inputs
    (tests)."""
    n, c = rois.shape[0], table_shape[1]
    o, r = output_size, sampling_ratio
    os_ = o * r
    dev = grad.device
    corners = _corners(rois, geom, scale, o, r)
    rows = torch.stack([i for i, _ in corners], -1).reshape(-1)
    w = torch.stack([wg for _, wg in corners], -1).to(grad.dtype).float()
    w = w.reshape(-1)
    # a term's upstream element: (ROI, bin row, bin column); its place in
    # the order: (that element, sample row in the bin, sample column)
    s = torch.arange(os_, device=dev)
    bins = ((torch.arange(n, device=dev)[:, None, None] * o
             + (s // r)[None, :, None]) * o + (s // r)[None, None, :])
    key = (bins * r + (s % r)[None, :, None]) * r + (s % r)[None, None, :]
    bins = bins.reshape(-1).repeat_interleave(4)
    key = key.reshape(-1).repeat_interleave(4)
    keep = w != 0
    rows, w, key, bins = rows[keep], w[keep], key[keep], bins[keep]
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    rows, w, bins = rows[order], w[order], bins[order]
    # each term's chunk: its ROI's place in its tile's list over the chunk
    on, row_tile = bwd_tile_lists(rois, geom, scale, o, r, layout)
    q = bwd_chunk_size(on.sum(1), BWD_PARTS if parts is None else parts)
    rank = torch.cumsum(on.long(), 1) - 1
    tile = row_tile[rows]
    chunk = rank[tile, bins // (o * o)] // q
    # a sum a (element, chunk), its terms ranked; then the chunks ranked
    part = torch.ones_like(rows, dtype=torch.bool)
    part[1:] = (rows[1:] != rows[:-1]) | (chunk[1:] != chunk[:-1])
    pid = torch.cumsum(part.long(), 0) - 1
    starts = torch.nonzero(part)[:, 0]
    at_k = torch.arange(len(rows), device=dev) - starts[pid]
    g = _div(grad.float().reshape(-1, c), r * r)
    sums = torch.zeros((len(starts), c), dtype=torch.float32, device=dev)
    for k in range(int(at_k.max()) + 1 if len(at_k) else 0):
        at = at_k == k
        idx = pid[at]
        sums[idx] = sums[idx] + g[bins[at]] * w[at][:, None]
    prow = rows[starts]
    first = torch.ones_like(prow, dtype=torch.bool)
    first[1:] = prow[1:] != prow[:-1]
    pstart = torch.nonzero(first)[:, 0]
    prank = torch.arange(len(prow), device=dev) - pstart[
        torch.cumsum(first.long(), 0) - 1]
    dtable = torch.zeros(table_shape, dtype=torch.float32, device=dev)
    for k in range(int(prank.max()) + 1 if len(prank) else 0):
        at = prank == k
        dtable[prow[at]] = dtable[prow[at]] + sums[at]
    return dtable.to(grad.dtype if dtype is None else dtype)
