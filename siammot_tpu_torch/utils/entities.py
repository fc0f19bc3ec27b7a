"""Boxes <-> AnnoEntity bridging (own copy of
``siammot_tpu.utils.entities``).

Converts a frame's padded ``Boxes`` rows to ``AnnoEntity`` records
(original-resolution xywh, confidence, {class: confidence} labels, id,
time) and given public detections (MOT17's, for instance) back into
padded tensors in network-input coordinates.  ``AnnoEntity`` keeps the
fields of ``siammot_tpu/data/motion_dataset.py:AnnoEntity`` that these two
functions use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.structures import Boxes

DEFAULT_CLASS_TABLE = {1: "person", 2: "vehicle"}


@dataclasses.dataclass
class AnnoEntity:
    """One box annotation or prediction at one video time."""

    time: float = 0.0                 # milliseconds
    id: int = -1
    bbox: list = None                 # [x, y, w, h]
    confidence: float = 1.0
    labels: dict = dataclasses.field(default_factory=dict)
    blob: dict = dataclasses.field(default_factory=dict)


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
        name = class_table.get(int(labels[i]), str(int(labels[i])))
        entities.append(AnnoEntity(
            time=time_ms, id=int(ids[i]),
            bbox=[float(x1), float(y1), float(x2 - x1 + 1),
                  float(y2 - y1 + 1)],
            confidence=float(scores[i]),
            labels={name: float(scores[i])},
            blob={"frame_idx": int(frame_idx)}))
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
