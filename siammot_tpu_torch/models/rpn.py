"""Region Proposal Network, inference (port of ``siammot_tpu.models.rpn``).

Detectron-rounded anchors, the shared 3x3 head, and the fixed-shape
proposal selection: per-level top-k -> decode (unit weights) -> clip ->
min-size filter -> one batched NMS over all levels -> top-k over levels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import boxes as box_ops
from ..core.nms import nms_mask


def base_anchors(stride: int, size: int,
                 aspect_ratios: Sequence[float]) -> np.ndarray:
    """Per-cell anchors for one FPN level, [A, 4] xyxy centred on cell 0."""
    base = np.array([0.0, 0.0, stride - 1.0, stride - 1.0])
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    area = w * h
    out = []
    scale = size / stride
    for r in aspect_ratios:
        ws = np.round(np.sqrt(area / r))
        hs = np.round(ws * r)
        ws, hs = ws * scale, hs * scale
        out.append([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                    cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])
    return np.asarray(out, np.float32)


def grid_anchors(feat_hw, stride: int, cell_anchors: np.ndarray) -> np.ndarray:
    """All anchors of one level, [(H*W*A), 4] in (y, x, a) order."""
    h, w = feat_hw
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      -1).reshape(-1, 1, 4)
    return (shifts + cell_anchors[None]).reshape(-1, 4)


class RPNHead(nn.Module):
    """Shared 3x3 + ReLU, then 1x1 objectness and 1x1 deltas."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, features):
        """NCHW maps -> per level NHWC logits [N,H,W,A], deltas [N,H,W,4A]."""
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1))
        return logits, deltas


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    pre_nms_top_n: int
    post_nms_top_n: int
    fpn_post_nms_top_n: int
    nms_thresh: float
    min_size: int
    amodal: bool

    @staticmethod
    def from_cfg(cfg) -> "RPNConfig":
        r = cfg.MODEL.RPN
        return RPNConfig(
            pre_nms_top_n=r.PRE_NMS_TOP_N_TEST,
            post_nms_top_n=r.POST_NMS_TOP_N_TEST,
            fpn_post_nms_top_n=r.FPN_POST_NMS_TOP_N_TEST,
            nms_thresh=r.NMS_THRESH,
            min_size=r.MIN_SIZE,
            amodal=bool(cfg.INPUT.AMODAL))


def topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, descending, ties to the lower index
    (``lax.top_k``): a stable sort, since ``torch.topk`` on the card
    leaves the order of ties open."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _topk_level(objectness, deltas, anchors, image_size, rcfg: RPNConfig,
                k: int):
    """One level, batched over images: top-k + decode + clip + min-size.

    objectness [N, HWA], deltas [N, HWA, 4], anchors [HWA, 4].
    Returns (boxes [N,k,4], scores [N,k], keep [N,k]); a level with fewer
    than k anchors is padded with keep=False rows scored -inf.
    """
    n, hwa = objectness.shape
    if hwa >= k:
        # the JAX package's grouped top-k (_grouped_topk) is a TPU speed
        # device with the flat top-k's result
        top_logits, idx = topk(objectness, k)
        top_scores = torch.sigmoid(top_logits)
        pad = torch.ones_like(top_scores, dtype=torch.bool)
    else:
        top_logits, sidx = topk(objectness, hwa)
        fill = k - hwa
        top_scores = torch.cat([torch.sigmoid(top_logits),
                                top_logits.new_full((n, fill), -np.inf)], 1)
        idx = torch.cat([sidx, sidx.new_zeros((n, fill))], 1)
        pad = torch.cat([torch.ones_like(sidx, dtype=torch.bool),
                         torch.zeros((n, fill), dtype=torch.bool,
                                     device=sidx.device)], 1)
    d = torch.gather(deltas, 1, idx[..., None].expand(n, k, 4))
    proposals = box_ops.decode(d, anchors[idx], weights=(1.0, 1.0, 1.0, 1.0))
    if not rcfg.amodal:
        proposals = box_ops.clip_to_image(proposals, image_size)
    keep = box_ops.min_size_mask(proposals, rcfg.min_size) & pad
    return proposals, top_scores, keep


def select_proposals(logits, deltas, anchors_per_level, image_size,
                     rcfg: RPNConfig):
    """Proposal selection for a batch (test path).

    logits: per level [N, H, W, A]; deltas: per level [N, H, W, 4A];
    anchors_per_level: per level [H*W*A, 4]; image_size (w, h).
    Returns (boxes [N, K, 4], objectness [N, K], valid [N, K]),
    K = fpn_post_nms_top_n.
    """
    k_pre = rcfg.pre_nms_top_n
    lv = []
    for lg, dl, anch in zip(logits, deltas, anchors_per_level):
        n = lg.shape[0]
        lv.append(_topk_level(lg.reshape(n, -1), dl.reshape(n, -1, 4),
                              anch, image_size, rcfg, k_pre))
    boxes = torch.stack([b for b, _, _ in lv])          # [L, N, k, 4]
    scores = torch.stack([s for _, s, _ in lv])
    keep = torch.stack([kp for _, _, kp in lv])
    # per-level candidates come straight out of a top-k, so the NMS can
    # skip its sort; one batched NMS covers every (level, image) set
    keep = nms_mask(boxes, scores, keep, rcfg.nms_thresh,
                    max_out=rcfg.post_nms_top_n, presorted=True)

    n = boxes.shape[1]
    boxes = boxes.permute(1, 0, 2, 3).reshape(n, -1, 4)
    scores = scores.permute(1, 0, 2).reshape(n, -1)
    keep = keep.permute(1, 0, 2).reshape(n, -1)

    k = min(rcfg.fpn_post_nms_top_n, boxes.shape[1])
    masked = torch.where(keep, scores, torch.full_like(scores, -np.inf))
    _, idx = topk(masked, k)
    sel_boxes = torch.gather(boxes, 1, idx[..., None].expand(n, k, 4))
    return (sel_boxes, torch.gather(scores, 1, idx),
            torch.gather(keep, 1, idx))
