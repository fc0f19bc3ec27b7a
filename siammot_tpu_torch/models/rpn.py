"""Region Proposal Network (port of ``siammot_tpu.models.rpn``).

Detectron-rounded anchors, the shared 3x3 head, and the fixed-shape
proposal selection: per-level top-k -> decode (unit weights) -> clip ->
min-size filter -> one batched NMS over all levels -> top-k over levels
(in training the last top-k is shared by the batch); and the training
loss (maskrcnn ``RPNLossComputation``: anchor matching, balanced
sampling, objectness BCE and smooth-L1 deltas).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import boxes as box_ops
from ..core.matcher import balanced_sample, match_targets
from ..core.nms import nms_mask
from ..core.structures import take_rows


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
    # training only (maskrcnn FPN_POST_NMS_PER_BATCH): the final top-n is
    # taken jointly over the batch instead of per image
    fpn_post_per_batch: bool = False
    straddle_thresh: float = 0.0
    fg_iou: float = 0.7
    bg_iou: float = 0.3
    batch_per_image: int = 256
    positive_fraction: float = 0.5

    @staticmethod
    def from_cfg(cfg, is_train: bool = False) -> "RPNConfig":
        r = cfg.MODEL.RPN
        phase = "TRAIN" if is_train else "TEST"
        return RPNConfig(
            pre_nms_top_n=r[f"PRE_NMS_TOP_N_{phase}"],
            post_nms_top_n=r[f"POST_NMS_TOP_N_{phase}"],
            fpn_post_nms_top_n=r[f"FPN_POST_NMS_TOP_N_{phase}"],
            nms_thresh=r.NMS_THRESH,
            min_size=r.MIN_SIZE,
            amodal=bool(cfg.INPUT.AMODAL),
            fpn_post_per_batch=bool(is_train and r.FPN_POST_NMS_PER_BATCH),
            straddle_thresh=float(r.STRADDLE_THRESH),
            fg_iou=r.FG_IOU_THRESHOLD,
            bg_iou=r.BG_IOU_THRESHOLD,
            batch_per_image=r.BATCH_SIZE_PER_IMAGE,
            positive_fraction=r.POSITIVE_FRACTION)


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
    K = fpn_post_nms_top_n; with ``fpn_post_per_batch`` only the batch's
    joint top K stay valid.
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
    sel_scores = torch.gather(scores, 1, idx)
    sel_valid = torch.gather(keep, 1, idx)
    # capping each image at the quota first is lossless: a survivor outside
    # its own image's top-n has n better ones in that image alone
    if rcfg.fpn_post_per_batch and n * k > rcfg.fpn_post_nms_top_n:
        flat = torch.where(sel_valid, sel_scores,
                           torch.full_like(sel_scores, -np.inf)).reshape(-1)
        _, gidx = topk(flat, rcfg.fpn_post_nms_top_n)
        gmask = torch.zeros(n * k, dtype=torch.bool, device=flat.device)
        sel_valid = sel_valid & gmask.index_fill(0, gidx, True).reshape(n, k)
    return sel_boxes, sel_scores, sel_valid


def smooth_l1(x, beta):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def rpn_loss(draw, logits, deltas, anchors_per_level, gt, image_size,
             rcfg: RPNConfig) -> dict:
    """RPN objectness + box loss, per image over all anchors, then the
    mean over the batch (``siammot_tpu/models/rpn.py:rpn_loss`` vmapped).

    logits per level [B, H, W, A]; deltas per level [B, H, W, 4A];
    anchors per level [H*W*A, 4]; gt: Boxes with [B, G] fields.
    """
    anchors = torch.cat(list(anchors_per_level))               # [T, 4]
    b = logits[0].shape[0]
    obj = torch.cat([l.reshape(b, -1) for l in logits], 1)      # [B, T]
    dlt = torch.cat([d.reshape(b, -1, 4) for d in deltas], 1)   # [B, T, 4]

    # anchor visibility (straddle_thresh 0: fully inside the image)
    w, h = image_size
    st = rcfg.straddle_thresh
    visible = ((anchors[:, 0] >= -st) & (anchors[:, 1] >= -st)
               & (anchors[:, 2] < w + st) & (anchors[:, 3] < h + st))

    quality = box_ops.box_iou(gt.boxes, anchors)                # [B, G, T]
    matches = match_targets(quality, gt.valid,
                            torch.ones_like(obj, dtype=torch.bool),
                            rcfg.fg_iou, rcfg.bg_iou,
                            allow_low_quality_matches=True)
    del quality

    labels = (matches >= 0).to(obj.dtype)
    discard = (matches == -2) | ~visible
    pos_mask = (matches >= 0) & ~discard
    neg_mask = (matches == -1) & ~discard
    sampled_pos, sampled_neg = balanced_sample(
        draw, pos_mask, neg_mask, rcfg.batch_per_image,
        rcfg.positive_fraction)
    sampled = sampled_pos | sampled_neg
    num_sampled = sampled.sum(-1).clamp(min=1)

    matched_gt = take_rows(gt.boxes, matches.clamp(min=0))
    # unit weights: maskrcnn's RPN BoxCoder (as on the decode side)
    reg_targets = box_ops.encode(matched_gt, anchors,
                                 weights=(1.0, 1.0, 1.0, 1.0))
    l1 = torch.where(sampled_pos[..., None],
                     smooth_l1(dlt - reg_targets, 1.0 / 9),
                     torch.zeros_like(dlt))
    box_l = l1.sum((1, 2)) / num_sampled

    bce = -(labels * F.logsigmoid(obj) + (1 - labels) * F.logsigmoid(-obj))
    obj_l = torch.where(sampled, bce, torch.zeros_like(bce)).sum(-1) \
        / num_sampled
    return {"loss_objectness": obj_l.mean(), "loss_rpn_box_reg": box_l.mean()}
