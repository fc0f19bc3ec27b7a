"""Fixed-shape box operations (port of ``siammot_tpu.core.boxes``).

maskrcnn conventions: ``TO_REMOVE = 1`` (width = x2 - x1 + 1) in area,
IoU, clipping and the box coder; ``bbox_xform_clip = log(1000/16)``.
Every set of boxes is a padded ``[N, 4]`` xyxy tensor.
"""

from __future__ import annotations

import math

import torch

TO_REMOVE = 1.0
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, ``[..., N, 4] x [..., M, 4] -> [..., N, M]``
    (maskrcnn ``boxlist_iou``)."""
    area_a = box_area(a)
    area_b = box_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    denom = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / denom.clamp(min=1e-12)


def clip_to_image(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clamp xyxy boxes to ``[0, size - 1]``; image_size is (w, h)."""
    w, h = image_size
    return torch.stack([boxes[..., 0].clamp(0, w - TO_REMOVE),
                        boxes[..., 1].clamp(0, h - TO_REMOVE),
                        boxes[..., 2].clamp(0, w - TO_REMOVE),
                        boxes[..., 3].clamp(0, h - TO_REMOVE)], dim=-1)


def nonempty_mask(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])


def min_size_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (w >= min_size) & (h >= min_size)


def encode(reference_boxes: torch.Tensor, proposals: torch.Tensor,
           weights=(10.0, 10.0, 5.0, 5.0)) -> torch.Tensor:
    """Faster R-CNN box encoding (maskrcnn ``BoxCoder.encode``): the
    deltas that take ``proposals`` to ``reference_boxes``, [..., 4]."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
    ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    return torch.stack([wx * (gt_cx - ex_cx) / ex_w,
                        wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w),
                        wh * torch.log(gt_h / ex_h)], dim=-1)


def decode(rel_codes: torch.Tensor, boxes: torch.Tensor,
           weights=(10.0, 10.0, 5.0, 5.0)) -> torch.Tensor:
    """Faster R-CNN box decoding (maskrcnn ``BoxCoder.decode``).

    rel_codes: [..., 4*k]; boxes: [..., 4]. Returns [..., 4*k] xyxy.
    """
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    heights = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = rel_codes[..., 0::4] / wx
    dy = rel_codes[..., 1::4] / wy
    dw = (rel_codes[..., 2::4] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (rel_codes[..., 3::4] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack([pred_ctr_x - 0.5 * pred_w,
                       pred_ctr_y - 0.5 * pred_h,
                       pred_ctr_x + 0.5 * pred_w - 1,
                       pred_ctr_y + 0.5 * pred_h - 1], dim=-1)
    return out.reshape(rel_codes.shape)


def extend_box(boxes: torch.Tensor, search_expansion: float,
               min_search_wh: float) -> torch.Tensor:
    """EMM search-region expansion (reference ``extend_bbox``)."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    w_ext = w * (search_expansion / 2.0)
    h_ext = h * (search_expansion / 2.0)
    if min_search_wh > 0:
        w_ext = torch.maximum((min_search_wh - w) / (search_expansion * 2.0),
                              w_ext)
        h_ext = torch.maximum((min_search_wh - h) / (search_expansion * 2.0),
                              h_ext)
    return torch.stack([boxes[..., 0] - w_ext, boxes[..., 1] - h_ext,
                        boxes[..., 2] + w_ext, boxes[..., 3] + h_ext], dim=-1)


def map_rois_to_levels(boxes: torch.Tensor, k_min: int, k_max: int,
                       canonical_scale: int = 224,
                       canonical_level: int = 4) -> torch.Tensor:
    """maskrcnn ``LevelMapper`` (FPN eqn. 1 with +1 box areas); level
    indices relative to ``k_min`` (``siammot_tpu/ops/roi_align.py``)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    s = torch.sqrt((w * h).clamp(min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-6))
    return (lvl.clamp(k_min, k_max) - k_min).to(torch.int32)
