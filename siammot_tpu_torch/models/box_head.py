"""Detection box head (port of ``siammot_tpu.models.box_head``).

maskrcnn FPN2MLPFeatureExtractor (7x7 windowed pool -> fc6 -> fc7) and
FPNPredictor, then SiamMOT's track-aware post-processing: rows carrying
a track id get +1 at their own label and zero elsewhere, so NMS never
suppresses a propagated track; per-class threshold + NMS for detections
only.  Training: the balanced proposal subsample and maskrcnn's
``FastRCNNLossComputation`` (``siammot_tpu/models/box_head.py:181-231``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import boxes as box_ops
from ..core.matcher import balanced_sample, match_targets
from ..core.nms import nms_mask
from ..core.structures import Boxes, take_rows
from ..ops.roi_align_windowed import windowed_pool
from .rpn import smooth_l1


class BoxHeadFeatureExtractor(nn.Module):
    def __init__(self, channels: int, resolution: int, sampling_ratio: int,
                 mlp_dim: int, window: int):
        super().__init__()
        self.resolution = resolution
        self.sampling_ratio = sampling_ratio
        self.window = window
        self.fc6 = nn.Linear(channels * resolution * resolution, mlp_dim)
        self.fc7 = nn.Linear(mlp_dim, mlp_dim)

    def forward(self, pack, rois, levels, valid, img_idx=None):
        """rois [R, 4], levels [R], valid [R] (None: the differentiable
        training pool), img_idx [R] (None: a one-image pack)."""
        pool = windowed_pool(pack, rois, img_idx, levels, self.resolution,
                             self.sampling_ratio, self.window, valid=valid)
        # the pool stays f32; the MLP runs in the trunk dtype.  fc6 reads
        # the (h, w, c) flatten of the NHWC pool, as flax's Dense does
        x = pool.reshape(pool.shape[0], -1).to(self.fc6.weight.dtype)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class BoxHeadPredictor(nn.Module):
    def __init__(self, mlp_dim: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(mlp_dim, num_classes)
        self.bbox_pred = nn.Linear(mlp_dim, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class BoxHead(nn.Module):
    def __init__(self, channels: int, resolution: int, sampling_ratio: int,
                 mlp_dim: int, num_classes: int, window: int):
        super().__init__()
        self.feature_extractor = BoxHeadFeatureExtractor(
            channels, resolution, sampling_ratio, mlp_dim, window)
        self.predictor = BoxHeadPredictor(mlp_dim, num_classes)

    def forward(self, pack, rois, levels, valid, img_idx=None):
        return self.predictor(self.feature_extractor(pack, rois, levels,
                                                     valid, img_idx))


@dataclasses.dataclass(frozen=True)
class BoxHeadConfig:
    score_thresh: float
    nms_thresh: float
    num_classes: int
    amodal: bool
    reg_weights: tuple
    fg_iou: float = 0.5
    bg_iou: float = 0.5
    batch_per_image: int = 256
    positive_fraction: float = 0.25

    @staticmethod
    def from_cfg(cfg) -> "BoxHeadConfig":
        r = cfg.MODEL.ROI_HEADS
        return BoxHeadConfig(
            score_thresh=r.SCORE_THRESH,
            nms_thresh=r.NMS,
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            amodal=bool(cfg.INPUT.AMODAL),
            reg_weights=tuple(r.BBOX_REG_WEIGHTS),
            fg_iou=r.FG_IOU_THRESHOLD,
            bg_iou=r.BG_IOU_THRESHOLD,
            batch_per_image=r.BATCH_SIZE_PER_IMAGE,
            positive_fraction=r.POSITIVE_FRACTION)


def postprocess(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                proposals: Boxes, image_size, hcfg: BoxHeadConfig) -> Boxes:
    """Track-aware post-processing, per image.

    class_logits [..., N, C], box_deltas [..., N, 4C] (leading axes: one
    image each).  Returns padded Boxes of capacity N * (C - 1), class
    blocks in class order: every (proposal, class) pair, its keep
    decision in ``valid``.  One NMS call covers every image and class.
    """
    *lead, n, c = class_logits.shape
    prob = torch.softmax(class_logits, dim=-1)
    is_track = (proposals.ids >= 0) & proposals.valid
    onehot = F.one_hot(proposals.labels.long(), c).to(prob.dtype)
    prob = torch.where(is_track[..., None], onehot * (prob + 1.0), prob)

    decoded = box_ops.decode(box_deltas, proposals.boxes,
                             hcfg.reg_weights).reshape(*lead, n, c, 4)
    if not hcfg.amodal:
        decoded = box_ops.clip_to_image(decoded, image_size)

    # classes 1..C-1 as a batch axis in front of the rows
    boxes = decoded[..., 1:, :].movedim(-2, -3)           # [..., C-1, N, 4]
    scores = prob[..., 1:].movedim(-1, -2)                # [..., C-1, N]
    valid = proposals.valid[..., None, :]
    track = is_track[..., None, :]
    above = (scores > hcfg.score_thresh) & valid
    det_keep = nms_mask(boxes, scores, above & ~track, hcfg.nms_thresh)
    shape = (*lead, c - 1, n)
    labels = torch.arange(1, c, dtype=torch.int32, device=boxes.device)
    rows = (*lead, (c - 1) * n)
    return Boxes(boxes=boxes.reshape(*rows, 4), scores=scores.reshape(rows),
                 ids=proposals.ids[..., None, :].expand(shape).reshape(rows),
                 labels=labels[:, None].expand(shape).reshape(rows),
                 valid=(det_keep | (above & track)).reshape(rows))


def subsample_proposals(draw, proposals: Boxes, gt: Boxes,
                        hcfg: BoxHeadConfig, num_samples: int):
    """Match each image's proposals to its gt and keep a balanced subset,
    compacted to the front.  Fields [B, M] in, [B, num_samples] out.

    Returns (sampled Boxes, cls_labels int32, reg_targets [B, S, 4]).
    """
    quality = box_ops.box_iou(gt.boxes, proposals.boxes)
    matches = match_targets(quality, gt.valid, proposals.valid,
                            hcfg.fg_iou, hcfg.bg_iou)
    matched = matches.clamp(min=0)
    labels = torch.where(matches >= 0, take_rows(gt.labels, matched),
                         torch.zeros_like(matches))
    labels = torch.where(matches == -2, torch.full_like(labels, -1), labels)

    sampled_pos, sampled_neg = balanced_sample(
        draw, labels > 0, labels == 0, hcfg.batch_per_image,
        hcfg.positive_fraction)
    sampled = sampled_pos | sampled_neg

    # sampled rows first, in their original order
    order = torch.argsort((~sampled).to(torch.int32), dim=-1,
                          stable=True)[:, :num_samples]
    reg_targets = box_ops.encode(take_rows(gt.boxes, matched),
                                 proposals.boxes, hcfg.reg_weights)
    labels = labels.to(torch.int32)
    out = Boxes(boxes=take_rows(proposals.boxes, order),
                scores=take_rows(proposals.scores, order),
                ids=take_rows(proposals.ids, order),
                labels=take_rows(labels, order),
                valid=take_rows(sampled, order))
    return out, out.labels, take_rows(reg_targets, order)


def box_head_loss(class_logits, box_deltas, labels, reg_targets,
                  valid) -> dict:
    """Classification cross entropy + class-specific smooth-L1 box loss,
    over samples flattened across the batch: class_logits [M, C],
    box_deltas [M, 4C], labels [M], reg_targets [M, 4], valid [M]."""
    num = valid.sum().clamp(min=1)
    lab = labels.clamp(min=0).long()
    logp = F.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 1, lab[:, None])[:, 0]
    cls_loss = torch.where(valid, ce, torch.zeros_like(ce)).sum() / num

    pos = valid & (labels > 0)
    cols = 4 * lab[:, None] + torch.arange(4, device=lab.device)
    picked = torch.gather(box_deltas, 1, cols)
    l1 = smooth_l1(picked - reg_targets, 1.0).sum(-1)
    box_loss = torch.where(pos, l1, torch.zeros_like(l1)).sum() / num
    return {"loss_classifier": cls_loss, "loss_box_reg": box_loss}


def pool_levels(boxes: torch.Tensor, num_levels: int) -> torch.Tensor:
    """FPN level of each box-head ROI (k_min=2, k_max=5)."""
    return box_ops.map_rois_to_levels(boxes, 2, 2 + num_levels - 1)
