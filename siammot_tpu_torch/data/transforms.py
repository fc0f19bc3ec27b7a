"""Host-side image transforms for inference (own copy of
``siammot_tpu.data.transforms``, without ``cv2``).

The reference's eval-time pipeline (maskrcnn Resize + Normalize): resize
the short side to MIN_SIZE_TEST unless the long side would pass
MAX_SIZE_TEST, pad to SIZE_DIVISIBILITY.  With ``TPU.DEVICE_NORMALIZE``
(the default) the frame stays uint8 and ``models.siammot.
normalize_images`` normalises it on the device; else ``x / 255`` (or BGR
255) is normalised by PIXEL_MEAN/STD here.  The resize is the frame
reader's bilinear (``data/native.py``), not ``cv2.INTER_LINEAR``.
"""

from __future__ import annotations

import numpy as np

from ..configs.defaults import resize_dims
from . import native

__all__ = ["EvalTransform", "pad_to_divisible", "resize_dims"]


def pad_to_divisible(x: np.ndarray, divisor: int = 32) -> np.ndarray:
    h, w = x.shape[:2]
    ph = -(-h // divisor) * divisor - h
    pw = -(-w // divisor) * divisor - w
    if ph or pw:
        x = np.pad(x, ((0, ph), (0, pw), (0, 0)))
    return x


class EvalTransform:
    """frame (HWC uint8 RGB) -> padded [1, H', W', 3] (uint8 with
    device normalisation, else normalised f32) plus the resized (w, h)
    before padding."""

    def __init__(self, cfg):
        self.min_size = cfg.INPUT.MIN_SIZE_TEST
        self.max_size = cfg.INPUT.MAX_SIZE_TEST
        self.mean = np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32)
        self.std = np.asarray(cfg.INPUT.PIXEL_STD, np.float32)
        self.to_bgr255 = cfg.INPUT.TO_BGR255
        self.divisor = cfg.DATALOADER.SIZE_DIVISIBILITY or 32
        self.device_normalize = bool(cfg.TPU.DEVICE_NORMALIZE)

    def input_size(self, w: int, h: int):
        return resize_dims(w, h, self.min_size, self.max_size)

    def __call__(self, frame: np.ndarray):
        h, w = frame.shape[:2]
        nw, nh = self.input_size(w, h)
        if (nw, nh) != (w, h):
            frame = native.resize_u8(frame, nw, nh)
        if self.device_normalize:
            x = pad_to_divisible(np.ascontiguousarray(frame), self.divisor)
            return x[None], (nw, nh)
        x = frame.astype(np.float32)
        if self.to_bgr255:
            x = x[..., ::-1]
        else:
            x = x / 255.0
        x = (x - self.mean) / self.std
        x = pad_to_divisible(x, self.divisor)
        return x[None], (nw, nh)
