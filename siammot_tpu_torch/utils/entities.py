"""Boxes <-> AnnoEntity bridging (own copy of
``siammot_tpu.utils.entities``).

Converts a frame's padded ``Boxes`` rows to ``data.motion_dataset.
AnnoEntity`` records (original-resolution xywh, confidence, {class:
confidence} labels, id, time, frame index) and given public detections
(MOT17's, for instance) back into padded tensors in network-input
coordinates, one set per frame or, for the multi-stream step, one set per
stream stacked into ``[S, G]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.structures import Boxes, stack_boxes
from ..data.motion_dataset import AnnoEntity

DEFAULT_CLASS_TABLE = {1: "person", 2: "vehicle"}


def boxes_to_entities(out: dict, frame_idx: int, time_ms: float,
                      scale_xy=(1.0, 1.0), class_table=None) -> list:
    """Valid rows of a solver output (``Boxes.numpy()``, as
    ``track_frames`` returns them) -> AnnoEntities in original-resolution
    xywh (+1 width convention, matching BoxList.convert('xywh'))."""
    class_table = class_table or DEFAULT_CLASS_TABLE
    boxes, scores = np.asarray(out["boxes"]), np.asarray(out["scores"])
    ids, labels = np.asarray(out["ids"]), np.asarray(out["labels"])
    valid = np.asarray(out["valid"])

    sx, sy = scale_xy
    entities = []
    for i in np.flatnonzero(valid):
        x1, y1, x2, y2 = boxes[i]
        x1, x2 = x1 * sx, x2 * sx
        y1, y2 = y1 * sy, y2 * sy
        e = AnnoEntity(time=time_ms, id=int(ids[i]))
        e.bbox = [float(x1), float(y1),
                  float(x2 - x1 + 1), float(y2 - y1 + 1)]
        e.confidence = float(scores[i])
        name = class_table.get(int(labels[i]), str(int(labels[i])))
        e.labels = {name: float(scores[i])}
        e.blob = {"frame_idx": int(frame_idx)}
        entities.append(e)
    return entities


def entities_to_boxes(entities: list, capacity: int, scale_xy=(1.0, 1.0),
                      class_table=None, device="cpu") -> Boxes:
    """Given public detections -> padded Boxes in network-input coords
    on ``device`` (reference ``convert_given_detections_to_boxlist``)."""
    class_table = class_table or DEFAULT_CLASS_TABLE
    name_to_label = {v: k for k, v in class_table.items()}

    boxes = np.zeros((capacity, 4), np.float32)
    scores = np.zeros((capacity,), np.float32)
    labels = np.zeros((capacity,), np.int32)
    valid = np.zeros((capacity,), bool)
    sx, sy = scale_xy
    for i, e in enumerate(entities[:capacity]):
        x, y, w, h = e.bbox
        boxes[i] = [x * sx, y * sy, (x + max(w - 1, 0)) * sx,
                    (y + max(h - 1, 0)) * sy]
        scores[i] = e.confidence
        name = next(iter(e.labels), "person") if e.labels else "person"
        labels[i] = name_to_label.get(name, 1)
        valid[i] = True
    return Boxes(boxes=torch.from_numpy(boxes).to(device),
                 scores=torch.from_numpy(scores).to(device),
                 ids=torch.full((capacity,), -1, dtype=torch.int32,
                                device=device),
                 labels=torch.from_numpy(labels).to(device),
                 valid=torch.from_numpy(valid).to(device))


def entities_to_stacked_boxes(per_stream: list, capacity: int, scales: list,
                              class_table=None, device="cpu") -> Boxes:
    """Given detections of S streams (one entity list each, scaled by its
    stream's (sx, sy) in ``scales``) -> Boxes stacked ``[S, capacity]``;
    an empty list (a stream with no detections, or without a frame at
    this step) gives an all-invalid set."""
    return stack_boxes([entities_to_boxes(e, capacity, sc, class_table,
                                          device)
                        for e, sc in zip(per_stream, scales)])
