"""Host-side per-frame ground-truth container of the training data
pipeline (own copy of ``siammot_tpu.data.target``, numpy, so every box
operation that decides the gt is the JAX package's, bit for bit).

Numpy stand-in for the dynamically-sized maskrcnn ``BoxList`` that the
reference's datasets and augmentation pass around (boxes + ``ids`` +
``labels``).  The step never sees this class: the batch collator
(``data/datasets.py:ClipCollator``) pads it into the fixed-capacity
``core.structures.Boxes``.

Box conventions match ``core/boxes.py`` (maskrcnn TO_REMOVE=1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

TO_REMOVE = 1.0


@dataclass
class FrameTarget:
    """Boxes (xyxy) + ids + labels for one frame; ``size`` is (w, h)."""

    boxes: np.ndarray                        # [N, 4] float32 xyxy
    ids: np.ndarray                          # [N] int64
    labels: np.ndarray                       # [N] int64
    size: tuple                              # (width, height)

    @staticmethod
    def empty(size) -> "FrameTarget":
        return FrameTarget(boxes=np.zeros((0, 4), np.float32),
                           ids=np.zeros((0,), np.int64),
                           labels=np.zeros((0,), np.int64), size=size)

    @staticmethod
    def from_xywh(xywh, ids, labels, size) -> "FrameTarget":
        xywh = np.asarray(xywh, np.float32).reshape(-1, 4)
        boxes = np.stack([
            xywh[:, 0], xywh[:, 1],
            xywh[:, 0] + np.clip(xywh[:, 2] - TO_REMOVE, 0, None),
            xywh[:, 1] + np.clip(xywh[:, 3] - TO_REMOVE, 0, None)], axis=-1)
        return FrameTarget(boxes=boxes,
                           ids=np.asarray(ids, np.int64).reshape(-1),
                           labels=np.asarray(labels, np.int64).reshape(-1),
                           size=size)

    def __len__(self) -> int:
        return len(self.boxes)

    def select(self, keep: np.ndarray) -> "FrameTarget":
        return FrameTarget(self.boxes[keep], self.ids[keep],
                           self.labels[keep], self.size)

    # -- geometry (BoxList method semantics) ---------------------------------

    def resize(self, new_size) -> "FrameTarget":
        """BoxList.resize: independent x / y ratios."""
        rw = new_size[0] / self.size[0]
        rh = new_size[1] / self.size[1]
        scale = np.array([rw, rh, rw, rh], np.float32)
        return FrameTarget(self.boxes * scale, self.ids, self.labels,
                           tuple(new_size))

    def hflip(self) -> "FrameTarget":
        """BoxList.transpose(FLIP_LEFT_RIGHT): x -> W - x - 1."""
        w = self.size[0]
        b = self.boxes
        flipped = np.stack([w - b[:, 2] - TO_REMOVE, b[:, 1],
                            w - b[:, 0] - TO_REMOVE, b[:, 3]], axis=-1)
        return FrameTarget(flipped.astype(np.float32), self.ids, self.labels,
                           self.size)

    def crop_shift(self, x1: float, y1: float, x2: float, y2: float,
                   amodal: bool) -> "FrameTarget":
        """Shift boxes into the crop window (x1,y1,x2,y2) and drop the ones
        that fall outside (reference ``ImageCropResize.boxlist_crop``,
        ``image_augmentation.py:75-101``)."""
        w, h = x2 - x1, y2 - y1
        b = self.boxes - np.array([x1, y1, x1, y1], np.float32)
        t = FrameTarget(b, self.ids, self.labels, (w, h))
        if amodal:
            # keep boxes with any visible part; corners may exceed bounds
            xx1 = np.clip(b[:, 0], 0, w - 1)
            yy1 = np.clip(b[:, 1], 0, h - 1)
            xx2 = np.clip(b[:, 2], 0, w - 1)
            yy2 = np.clip(b[:, 3], 0, h - 1)
            return t.select((xx2 > xx1) & (yy2 > yy1))
        return t.clip_to_image(remove_empty=True)

    def clip_to_image(self, remove_empty: bool = True) -> "FrameTarget":
        w, h = self.size
        b = self.boxes.copy()
        b[:, 0::2] = np.clip(b[:, 0::2], 0, w - TO_REMOVE)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, h - TO_REMOVE)
        t = FrameTarget(b, self.ids, self.labels, self.size)
        if remove_empty:
            return t.select((b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1]))
        return t
