"""Detection box head (port of ``siammot_tpu.models.box_head``).

maskrcnn FPN2MLPFeatureExtractor (7x7 windowed pool -> fc6 -> fc7) and
FPNPredictor, then SiamMOT's track-aware post-processing: rows carrying
a track id get +1 at their own label and zero elsewhere, so NMS never
suppresses a propagated track; per-class threshold + NMS for detections
only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import boxes as box_ops
from ..core.nms import nms_mask
from ..core.structures import Boxes
from ..ops.roi_align_windowed import windowed_pool


class BoxHeadFeatureExtractor(nn.Module):
    def __init__(self, channels: int, resolution: int, sampling_ratio: int,
                 mlp_dim: int, window: int):
        super().__init__()
        self.resolution = resolution
        self.sampling_ratio = sampling_ratio
        self.window = window
        self.fc6 = nn.Linear(channels * resolution * resolution, mlp_dim)
        self.fc7 = nn.Linear(mlp_dim, mlp_dim)

    def forward(self, pack, rois, levels, valid):
        """rois [R, 4], levels [R], valid [R] for one image."""
        img_idx = torch.zeros_like(levels)
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

    def forward(self, pack, rois, levels, valid):
        return self.predictor(self.feature_extractor(pack, rois, levels,
                                                     valid))


@dataclasses.dataclass(frozen=True)
class BoxHeadConfig:
    score_thresh: float
    nms_thresh: float
    num_classes: int
    amodal: bool
    reg_weights: tuple

    @staticmethod
    def from_cfg(cfg) -> "BoxHeadConfig":
        return BoxHeadConfig(
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS,
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            amodal=bool(cfg.INPUT.AMODAL),
            reg_weights=tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS))


def postprocess(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                proposals: Boxes, image_size, hcfg: BoxHeadConfig) -> Boxes:
    """Track-aware post-processing for one image.

    class_logits [N, C], box_deltas [N, 4C].  Returns padded Boxes of
    capacity N * (C - 1): every (proposal, class) pair, its keep decision
    in ``valid``.
    """
    n, c = class_logits.shape
    prob = torch.softmax(class_logits, dim=-1)
    is_track = (proposals.ids >= 0) & proposals.valid
    onehot = F.one_hot(proposals.labels.long(), c).to(prob.dtype)
    prob = torch.where(is_track[:, None], onehot * (prob + 1.0), prob)

    decoded = box_ops.decode(box_deltas, proposals.boxes,
                             hcfg.reg_weights).reshape(n, c, 4)
    if not hcfg.amodal:
        decoded = box_ops.clip_to_image(decoded, image_size)

    outs = []
    for j in range(1, c):
        boxes_j = decoded[:, j]
        scores_j = prob[:, j]
        above = (scores_j > hcfg.score_thresh) & proposals.valid
        det_keep = nms_mask(boxes_j, scores_j, above & ~is_track,
                            hcfg.nms_thresh)
        outs.append(Boxes(
            boxes=boxes_j, scores=scores_j, ids=proposals.ids,
            labels=torch.full((n,), j, dtype=torch.int32,
                              device=boxes_j.device),
            valid=det_keep | (above & is_track)))
    return Boxes(*(torch.cat([getattr(o, f.name) for o in outs])
                   for f in dataclasses.fields(Boxes)))


def pool_levels(boxes: torch.Tensor, num_levels: int) -> torch.Tensor:
    """FPN level of each box-head ROI (k_min=2, k_max=5)."""
    return box_ops.map_rois_to_levels(boxes, 2, 2 + num_levels - 1)
