"""Clip-consistent training augmentation (port of
``siammot_tpu.data.augmentation``, without ``cv2``).

  ColorJitter (ONE random frame of the pair) -> MotionBlur (one frame,
  with prob) -> JPEG compression (one frame) -> MotionAugment (random
  crop-resize of ONE frame = synthetic inter-frame motion for image
  datasets, amodal-aware) -> multi-scale resize (same new size for both
  frames, floored to SIZE_DIVISIBILITY) -> clip-consistent HFlip ->
  normalize (x/255, PIXEL_MEAN/STD).

Every transform is ``(frames, targets, rng) -> (frames, targets)`` over
uint8 RGB HWC frames and ``FrameTarget`` boxes, and consumes the
``random.Random`` draws the JAX transform consumes, in the same order, so
a seeded item is the same clip in both packages.  The numpy arithmetic is
the JAX package's line for line; each ``cv2`` call there is OpenCV's
arithmetic reproduced in ``augment.cpp`` (``data/native.py``): the
resize, the HSV conversions, the motion-blur kernel's ``warpAffine``,
``filter2D`` and ``GaussianBlur`` give OpenCV's bytes (OpenCV 5's; the
tests hold them to the JAX package's ``cv2``).  The JPEG round trip
follows the device: libjpeg on the CPU (the bytes of ``cv2.imencode`` and
``imdecode``), nvJPEG's encoder and decoder on the card, whose bytes are
nvJPEG's own.
"""

from __future__ import annotations

import math
import random
from typing import Sequence

import numpy as np

from . import native
from .target import FrameTarget


class Compose:
    def __init__(self, transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, frames, targets, rng: random.Random):
        for t in self.transforms:
            frames, targets = t(frames, targets, rng)
        return frames, targets


# ---------------------------------------------------------------------------
# Photometric (applied to ONE random frame of the pair, like the reference)
# ---------------------------------------------------------------------------

class ColorJitter:
    """torchvision ColorJitter semantics (random order of brightness /
    contrast / saturation / hue, factors U[max(0,1-x), 1+x], hue U[-h, h]);
    parameters drawn once, applied to one random frame."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.enabled = any(v > 0 for v in (brightness, contrast, saturation,
                                           hue))

    @staticmethod
    def _blend(a, b, f):
        return np.clip(f * a + (1.0 - f) * b, 0, 255)

    def _apply(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        x = img.astype(np.float32)
        ops = []
        if self.b > 0:
            f = rng.uniform(max(0.0, 1 - self.b), 1 + self.b)
            ops.append(lambda x: np.clip(x * f, 0, 255))
        if self.c > 0:
            f = rng.uniform(max(0.0, 1 - self.c), 1 + self.c)

            def contrast(x, f=f):
                gray_mean = (x @ np.array([0.299, 0.587, 0.114],
                                          np.float32)).mean()
                return self._blend(x, gray_mean, f)
            ops.append(contrast)
        if self.s > 0:
            f = rng.uniform(max(0.0, 1 - self.s), 1 + self.s)

            def sat(x, f=f):
                gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
                return self._blend(x, gray[..., None], f)
            ops.append(sat)
        if self.h > 0:
            d = rng.uniform(-self.h, self.h)

            def hue(x, d=d):
                hsv = native.rgb_to_hsv(x.astype(np.uint8))
                # OpenCV hue is [0, 180); torchvision hue factor is in turns
                hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                               + int(round(d * 180))) % 180
                return native.hsv_to_rgb(hsv).astype(np.float32)
            ops.append(hue)
        rng.shuffle(ops)
        for op in ops:
            x = op(x)
        return x.astype(np.uint8)

    def __call__(self, frames, targets, rng):
        if not self.enabled or len(frames) < 2:
            return frames, targets
        idx = rng.choice((0, 1))
        frames = list(frames)
        frames[idx] = self._apply(frames[idx], rng)
        return frames, targets


def rotation_matrix(cx: float, cy: float, angle_deg: float) -> list:
    """``cv2.getRotationMatrix2D((cx, cy), angle_deg, 1.0)``, row-major."""
    a = angle_deg * math.pi / 180
    alpha, beta = math.cos(a), math.sin(a)
    return [alpha, beta, (1 - alpha) * cx - beta * cy,
            -beta, alpha, beta * cx + (1 - alpha) * cy]


def gaussian_taps(sigma: float) -> np.ndarray:
    """The Q8 taps ``cv2.GaussianBlur(img, (0, 0), sigma)`` applies to 8-bit
    images: kernel size round(6 sigma + 1) | 1, exp(-x^2 / (2 sigma^2))
    normalised, the first half rounded to 1/256 with its error carried to
    the next tap, the centre what makes the sum 256."""
    n = int(np.rint(sigma * 3 * 2 + 1)) | 1
    scale = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    vals = [math.exp(float(x * x) * scale) for x in range(1 - n, -1, 2)]
    inv = 1.0 / (2 * sum(vals) + 1.0)
    err, taps = 0.0, []
    for v in vals[:half]:
        adj = v * inv * 256.0 + err
        q = int(np.rint(adj))
        err = adj - q
        taps.append(q)
    return np.array(taps + [256 - 2 * sum(taps)] + taps[::-1], np.uint16)


class MotionBlur:
    """One frame, with probability ``prob``: random pick of directional
    motion blur (k=10, angle U[-30, 30] — imgaug MotionBlur) or Gaussian
    blur (sigma U[0, 2])."""

    def __init__(self, prob=0.0, kernel_size=10, angle=30.0, max_sigma=2.0):
        self.prob = prob
        self.k = kernel_size
        self.angle = angle
        self.max_sigma = max_sigma

    def _motion_kernel(self, angle_deg: float) -> np.ndarray:
        k = self.k
        kern = np.zeros((k, k), np.float32)
        kern[k // 2, :] = 1.0
        kern = native.warp_affine(kern, rotation_matrix(
            k / 2 - 0.5, k / 2 - 0.5, angle_deg))
        s = kern.sum()
        return kern / s if s > 0 else kern

    def __call__(self, frames, targets, rng):
        if self.prob <= 0 or len(frames) < 2:
            return frames, targets
        idx = rng.choice((0, 1))
        if rng.uniform(0, 1) >= self.prob:
            return frames, targets
        frames = list(frames)
        if rng.choice((0, 1)) == 0:
            kern = self._motion_kernel(rng.uniform(-self.angle, self.angle))
            frames[idx] = native.filter2d(frames[idx], kern)
        else:
            sigma = rng.uniform(0.0, self.max_sigma)
            if sigma > 1e-3:
                frames[idx] = native.gaussian_blur(frames[idx],
                                                   gaussian_taps(sigma))
        return frames, targets


class JpegCompression:
    """One frame: JPEG round-trip at compression U[0, max_compression]
    (quality = 100 - compression), on ``device``'s route (libjpeg on the
    CPU, nvJPEG on the card)."""

    def __init__(self, max_compression=0.0, device="cpu"):
        self.max_compression = max_compression
        self.device = device

    def __call__(self, frames, targets, rng):
        if self.max_compression <= 0 or len(frames) < 2:
            return frames, targets
        idx = rng.choice((0, 1))
        compression = min(100, int(rng.uniform(0, 1) * self.max_compression))
        quality = 100 - compression
        frames = list(frames)
        frames[idx] = native.jpeg_roundtrip(frames[idx], quality, self.device)
        return frames, targets


# ---------------------------------------------------------------------------
# Geometric
# ---------------------------------------------------------------------------

class MotionAugment:
    """Synthetic inter-frame motion: crop-resize ONE frame of the pair.

    The crop keeps aspect ratio, is bounded so the largest box keeps at
    least 75% visible, and the frame is resized back to its original size
    (boxes shifted + rescaled; amodal keeps out-of-bounds corners)."""

    def __init__(self, motion_limit=0.0, amodal=False):
        self.motion_limit = min(0.1, motion_limit or 0.0)
        self.amodal = amodal

    def _crop_resize(self, img: np.ndarray, target: FrameTarget,
                     rng: random.Random):
        h, w = img.shape[:2]
        tl_x = int(w * rng.random() * self.motion_limit)
        tl_y = int(h * rng.random() * self.motion_limit)
        br_x = int(w - w * rng.random() * self.motion_limit)
        br_y = int((h / w) * (br_x - tl_x) + tl_y)  # keep aspect ratio

        if len(target) > 0:
            b = target.boxes
            bw = np.clip(b[:, 2], 0, w - 1) - np.clip(b[:, 0], 0, w - 1)
            bh = np.clip(b[:, 3], 0, h - 1) - np.clip(b[:, 1], 0, h - 1)
            i = int(np.argmax(bw * bh))
            # preserve at least one box after the crop
            tl_x = min(tl_x, int(bw[i] * 0.25))
            tl_y = min(tl_y, int(bh[i] * 0.25))
            br_x = max(br_x, w - int(bw[i] * 0.25))
            br_y = max(br_y, h - int(bh[i] * 0.25))
        br_y = min(br_y, h)
        if tl_x >= br_x or tl_y >= br_y:
            return img, target

        crop = native.cv_resize(img[tl_y:br_y, tl_x:br_x], w, h)
        target = target.crop_shift(tl_x, tl_y, br_x, br_y, self.amodal)
        return crop, target.resize((w, h))

    def __call__(self, frames, targets, rng):
        if self.motion_limit == 0 or len(frames) < 2:
            return frames, targets
        idx = rng.choice((0, 1))
        frames, targets = list(frames), list(targets)
        frames[idx], targets[idx] = self._crop_resize(frames[idx],
                                                      targets[idx], rng)
        return frames, targets


def train_resize_dims(w: int, h: int, min_sizes: Sequence[int], max_size: int,
                      divisibility: int, rng: random.Random):
    """Reference ``ImageResize.get_size``: random short-side choice,
    long-side cap, FLOOR to divisibility.  Returns (new_w, new_h)."""
    size = rng.choice(tuple(min_sizes))
    mn, mx = float(min(w, h)), float(max(w, h))
    if max_size is not None and mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    if divisibility > 0:
        oh = int(oh / divisibility) * divisibility
        ow = int(ow / divisibility) * divisibility
    return ow, oh


class ClipResize:
    """Same new size for every frame of the clip, computed from frame 0."""

    def __init__(self, min_sizes, max_size, divisibility):
        self.min_sizes = min_sizes if isinstance(min_sizes, (list, tuple)) \
            else (min_sizes,)
        self.max_size = max_size
        self.divisibility = divisibility

    def __call__(self, frames, targets, rng):
        h, w = frames[0].shape[:2]
        nw, nh = train_resize_dims(w, h, self.min_sizes, self.max_size,
                                   self.divisibility, rng)
        out_f, out_t = [], []
        for img, t in zip(frames, targets):
            out_f.append(native.cv_resize(img, nw, nh))
            out_t.append(t.resize((nw, nh)))
        return out_f, out_t


class ClipHFlip:
    """All frames flip together or none."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, frames, targets, rng):
        if rng.random() >= self.prob:
            return frames, targets
        return ([np.ascontiguousarray(f[:, ::-1]) for f in frames],
                [t.hflip() for t in targets])


class Normalize:
    """x/255 then (x - mean) / std, float32 HWC output."""

    def __init__(self, mean, std, to_bgr255=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255

    def __call__(self, frames, targets, rng):
        out = []
        for f in frames:
            x = f.astype(np.float32)
            if self.to_bgr255:
                x = x[..., ::-1]
            else:
                x = x / 255.0
            out.append((x - self.mean) / self.std)
        return out, targets


def build_siam_augmentation(cfg, is_train=True, modality="video",
                            device="cpu") -> Compose:
    """The reference builder: photometric + synthetic-motion transforms
    only at train time, and the crop-based motion / blur / compression
    only for image (pseudo-video) datasets.  ``device`` picks the JPEG
    round trip's route."""
    motion_limit = blur_prob = compression = 0.0
    if is_train:
        min_size = cfg.INPUT.MIN_SIZE_TRAIN
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
        flip_prob = cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN
        jitter = ColorJitter(cfg.INPUT.BRIGHTNESS, cfg.INPUT.CONTRAST,
                             cfg.INPUT.SATURATION, cfg.INPUT.HUE)
        if modality == "image":
            motion_limit = cfg.INPUT.MOTION_LIMIT
            blur_prob = cfg.INPUT.MOTION_BLUR_PROB
            compression = cfg.INPUT.COMPRESSION_LIMIT
    else:
        min_size = cfg.INPUT.MIN_SIZE_TEST
        max_size = cfg.INPUT.MAX_SIZE_TEST
        flip_prob = 0.0
        jitter = None

    steps = [
        jitter,
        MotionBlur(blur_prob),
        JpegCompression(compression, device),
        MotionAugment(motion_limit, cfg.INPUT.AMODAL),
        ClipResize(min_size, max_size, cfg.DATALOADER.SIZE_DIVISIBILITY),
        ClipHFlip(flip_prob),
    ]
    if not cfg.TPU.DEVICE_NORMALIZE:
        # host-side normalization (the reference pipeline); by default raw
        # uint8 frames go to the device (models.siammot.normalize_images)
        steps.append(Normalize(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                               cfg.INPUT.TO_BGR255))
    return Compose(steps)
