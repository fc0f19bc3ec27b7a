"""Box, id and class overlays for the demo (counterpart of
``demos/utils/vis_generator.py``, without ``cv2`` or matplotlib).

The frame stays RGB and the colours are reversed to match, so the pixels
written equal the JAX demo's BGR frame with its channels reversed: the
same 50 colours (``colors.get_n_colors``), only rows with id >= 0 drawn,
a rectangle at thickness 3, the id in the box, a filled banner with the
class name above it (``draw.py``).  With ``vis_height`` the frame is
resized first, as ``cv2.resize`` resizes it (``data/native.py:
cv_resize``).
"""

from __future__ import annotations

import numpy as np

from ...data import native
from . import draw
from .colors import get_n_colors

COCO_CLASS_NAMES = ["person", "bicycle", "car", "motorcycle", "airplane",
                    "bus", "train", "truck", "boat"]


class VisGenerator:
    def __init__(self, vis_height=None):
        self._vis_height = vis_height
        self.num_colors = 50
        self.colors = get_n_colors(self.num_colors)      # RGB
        self.class_names = COCO_CLASS_NAMES

    def normalize_output(self, frame, boxes_xyxy):
        """Optionally rescale the frame (and boxes) to vis_height."""
        if self._vis_height is None:
            return frame, boxes_xyxy
        fh, fw = frame.shape[:2]
        ratio = float(self._vis_height) / fh
        frame = native.cv_resize(frame, int(round(fw * ratio)),
                                 int(round(fh * ratio)))
        return frame, boxes_xyxy * ratio

    def frame_vis_generator(self, frame: np.ndarray, boxes_xyxy: np.ndarray,
                            ids: np.ndarray, labels: np.ndarray):
        """frame: RGB uint8 (drawn on a copy); only id >= 0 rows are
        rendered."""
        frame = np.array(frame, np.uint8, order="C")
        keep = ids >= 0
        boxes_xyxy, ids, labels = boxes_xyxy[keep], ids[keep], labels[keep]
        frame, boxes_xyxy = self.normalize_output(frame, boxes_xyxy)
        for box, eid, lab in zip(boxes_xyxy, ids, labels):
            color = self.colors[int(eid) % self.num_colors]
            name = self.class_names[max(int(lab) - 1, 0)] \
                if int(lab) - 1 < len(self.class_names) else str(int(lab))
            x1, y1, x2, y2 = np.round(box).astype(int)
            draw.rectangle(frame, (x1, y1), (x2, y2), color, thickness=3)
            draw.put_text(frame, str(int(eid)), (x1 + 5, y1 + 40), "id",
                          color)
            draw.rectangle(frame, (x1 - 5, y1 - 25),
                           (x1 + len(name) * 20, y1), color, -1)
            draw.put_text(frame, name, (x1 + 5, y1 - 5), "name", (0, 0, 0))
        return frame
