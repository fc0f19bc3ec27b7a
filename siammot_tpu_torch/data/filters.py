"""Dataset-specific entity filters (own copy of
``siammot_tpu.data.filters``): each filter splits a frame's entities
into (valid, ignored); predictions
overlapping an ignored GT region are themselves ignored during eval.
"""

from __future__ import annotations

import numpy as np


def bbs_iou(a, b) -> float:
    """xywh IoU between two entities (reference entity_utils.bbs_iou)."""
    ax, ay, aw, ah = a.bbox
    bx, by, bw, bh = b.bbox
    x1, y1 = max(ax, bx), max(ay, by)
    x2, y2 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


class BaseFilter:
    def _filter(self, entity, ignored_gt_entities=None) -> bool:
        return False

    def __call__(self, entities, ignored_entities=None, meta_data=None):
        valid, ignored = [], []
        for e in entities:
            (ignored if self._filter(e, ignored_entities) else valid).append(e)
        return valid, ignored


class CRPFilter(BaseFilter):
    """Caltech Roadside Pedestrians: ignore negative-id GT; ignore
    predictions overlapping ignored GT at IoU >= 0.2."""

    def __init__(self, iou_thresh=0.2, is_train=False):
        self.iou_thresh = iou_thresh

    def _filter(self, entity, ignored_gt_entities=None):
        if ignored_gt_entities is None:
            return entity.id < 0
        return any(bbs_iou(entity, g) >= self.iou_thresh
                   for g in ignored_gt_entities)


class MOTFilter(BaseFilter):
    """MOT: train drops low-visibility / non-person GT; eval keeps person
    boxes with a valid id and ignores predictions on ignored regions."""

    def __init__(self, visibility_thresh=0.1, iou_thresh=0.5, is_train=False):
        self.visibility_thresh = visibility_thresh
        self.iou_thresh = iou_thresh
        self.is_train = is_train

    def _filter(self, entity, ignored_gt_entities=None):
        if ignored_gt_entities is None:
            if self.is_train:
                visible = entity.blob.get("visibility", 1.0)
                person_like = any(k in ("person", "2", "7")
                                  for k in entity.labels)
                return visible < self.visibility_thresh or not person_like
            return "person" not in entity.labels or int(entity.id) < 0
        return any(bbs_iou(entity, g) >= self.iou_thresh
                   for g in ignored_gt_entities)


class AOTFilter(BaseFilter):
    """Airborne Object Tracking: keep intruders within range < 1200 m."""

    def __init__(self, range_distance_thresh=1200, iou_thresh=0.2,
                 is_train=False):
        self.range_distance_thresh = range_distance_thresh
        self.iou_thresh = iou_thresh

    def _filter(self, entity, ignored_gt_entities=None):
        if ignored_gt_entities is None:
            rng = entity.blob.get("range_distance_m", np.inf)
            labels = entity.labels or {}
            return "intruder" not in labels or rng >= self.range_distance_thresh
        return any(g.bbox is not None and bbs_iou(entity, g) >= self.iou_thresh
                   for g in ignored_gt_entities)


def build_data_filter_fn(dataset_key: str, *args, **kwargs):
    """Key -> filter (reference ``build_data_filter_fn``)."""
    if dataset_key == "CRP":
        return CRPFilter(*args, **kwargs)
    if dataset_key.startswith("MOT") or dataset_key.startswith("SYNMOT"):
        # SYNMOT is a MOT-format stand-in: same visibility/person rules
        return MOTFilter(*args, **kwargs)
    if dataset_key == "AOT":
        return AOTFilter(*args, **kwargs)
    return None
