"""Crowded synthetic 720p scene for driving the tracker (numpy only).

Own copy of ``bench.py:render_scene`` and of the ``Sprite``/``_texture``
renderer in ``tools/make_synth_mot.py``: textured person-shaped sprites
with constant-velocity-plus-noise motion over a smooth textured
background.  The random draws are the same, in the same order, as the
originals; ``cv2.resize`` is replaced by the numpy resizes below
(half-pixel bilinear, and nearest), which may differ from OpenCV's
fixed-point rounding by one grey level.  ``train_batches`` cuts two
scenes into training batches of clip pairs with their sprite boxes as
ground truth; ``public_detections`` makes a public detector's output
from the sprite boxes, as MOT17's public detections arrive.
"""

from __future__ import annotations

import numpy as np

H, W = 720, 1280
N_SPRITES = 40


def _resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Half-pixel bilinear resize of a uint8 [h, w, ...] image."""
    ih, iw = img.shape[:2]

    def axis(n_out, n_in):
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        src = np.clip(src, 0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (src - lo).astype(np.float32)

    ylo, yhi, fy = axis(h, ih)
    xlo, xhi, fx = axis(w, iw)
    a = img.astype(np.float32)
    fx = fx.reshape((1, w) + (1,) * (a.ndim - 2))
    fy = fy.reshape((h, 1) + (1,) * (a.ndim - 2))
    top = a[ylo][:, xlo] * (1 - fx) + a[ylo][:, xhi] * fx
    bot = a[yhi][:, xlo] * (1 - fx) + a[yhi][:, xhi] * fx
    return np.round(top * (1 - fy) + bot * fy).astype(np.uint8)


def _resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    ys = np.minimum((np.arange(h) * (ih / h)).astype(np.int64), ih - 1)
    xs = np.minimum((np.arange(w) * (iw / w)).astype(np.int64), iw - 1)
    return img[ys][:, xs]


def _texture(rng, h, w, scale=8, base=None):
    """Smooth random RGB texture via low-res noise upsampled bilinearly."""
    lo = rng.randint(0, 255, (max(2, h // scale), max(2, w // scale), 3),
                     np.uint8)
    tex = _resize_linear(lo, w, h)
    if base is not None:
        tex = (0.5 * tex + 0.5 * np.asarray(base)).astype(np.uint8)
    return tex


class Sprite:
    """A person-like textured blob with constant-velocity + noise motion."""

    def __init__(self, rng, sid, w, h):
        self.id = sid
        self.h = float(rng.uniform(0.12, 0.42) * h)
        self.w = self.h * rng.uniform(0.32, 0.52)
        self.x = rng.uniform(0, w - self.w)
        self.y = rng.uniform(0, h - self.h)
        speed = rng.uniform(1.0, 6.0)
        ang = rng.uniform(0, 2 * np.pi)
        self.vx = speed * np.cos(ang)
        self.vy = speed * np.sin(ang)
        self.scale_rate = rng.uniform(-0.004, 0.004)
        th, tw = max(8, int(self.h)), max(4, int(self.w))
        base = rng.randint(64, 255, (3,))
        self.tex = _texture(rng, th, tw, scale=4, base=base)
        self.tex[0, :] = self.tex[-1, :] = 16
        self.tex[:, 0] = self.tex[:, -1] = 16
        yy, xx = np.mgrid[0:th, 0:tw]
        cy, cx = (th - 1) / 2, (tw - 1) / 2
        self.mask = (((yy - cy) / (th / 2)) ** 2
                     + ((xx - cx) / (tw / 2)) ** 2) <= 1.0

    def step(self, rng, w, h):
        self.x += self.vx
        self.y += self.vy
        self.vx += rng.uniform(-0.3, 0.3)
        self.vy += rng.uniform(-0.3, 0.3)
        self.vx = np.clip(self.vx, -7, 7)
        self.vy = np.clip(self.vy, -7, 7)
        grow = 1.0 + self.scale_rate
        self.w *= grow
        self.h *= grow
        if self.x < 0:
            self.x, self.vx = 0, abs(self.vx)
        if self.y < 0:
            self.y, self.vy = 0, abs(self.vy)
        if self.x + self.w > w:
            self.x, self.vx = w - self.w, -abs(self.vx)
        if self.y + self.h > h:
            self.y, self.vy = h - self.h, -abs(self.vy)

    def draw(self, frame):
        """Paint the sprite; returns its box (x1, y1, x2, y2), inclusive
        pixel corners clipped to the frame."""
        x0, y0 = int(round(self.x)), int(round(self.y))
        bw, bh = max(2, int(round(self.w))), max(2, int(round(self.h)))
        x0 = min(max(x0, 0), frame.shape[1] - bw)
        y0 = min(max(y0, 0), frame.shape[0] - bh)
        tex = _resize_linear(self.tex, bw, bh)
        mask = _resize_nearest(self.mask, bw, bh)
        region = frame[y0:y0 + bh, x0:x0 + bw]
        region[mask] = tex[mask]
        x1, y1 = max(x0, 0), max(y0, 0)
        return (x1, y1, min(x0 + bw, frame.shape[1]) - 1,
                min(y0 + bh, frame.shape[0]) - 1)


def render_scene(n_frames: int, hp: int, seed: int = 42,
                 h: int = H, w: int = W):
    """Crowded sprite scene: ``n_frames`` uint8 frames [1, hp, w, 3], the
    content in the top ``h`` rows and zeros below (the pad to the
    size-divisible input height).  Returns (frames, boxes, ids): per
    frame, each sprite's box [N_SPRITES, 4] f32 and its persistent id
    [N_SPRITES] int32 (1..N_SPRITES)."""
    rng = np.random.RandomState(seed)
    bg = _texture(rng, h, w, scale=16)
    sprites = []
    for i in range(N_SPRITES):
        s = Sprite(rng, i + 1, w, 384)
        s.y = rng.uniform(0, h - s.h)
        sprites.append(s)
    frames, boxes = [], []
    ids = np.array([s.id for s in sprites], np.int32)
    for _ in range(n_frames):
        f = bg.copy()
        drawn = {s.id: s.draw(f) for s in sorted(sprites, key=lambda s: s.h)}
        boxes.append(np.array([drawn[i] for i in ids], np.float32))
        for s in sprites:
            s.step(rng, w, h)
        out = np.zeros((1, hp, w, 3), np.uint8)
        out[0, :h] = f
        frames.append(out)
    return frames, boxes, [ids] * n_frames


def train_batches(n_frames: int, hp: int, max_gt: int, seed: int = 42,
                  h: int = H, w: int = W):
    """Endless training batches from two ``n_frames``-frame scenes (seeds
    ``seed`` and ``seed + 1``): batch t holds frames (t, t + 1) of each
    scene, cycling over t, as two clips of two consecutive frames.

    Yields (images uint8 [4, hp, w, 3], gt Boxes with [4, max_gt] CPU
    fields (label 1, ids unique within the batch: the second scene's are
    offset by N_SPRITES), frame_sizes int32 [4, 2] (w, h)).
    """
    import torch

    from ..core.structures import Boxes

    if N_SPRITES > max_gt:
        raise ValueError(f"max_gt {max_gt} < {N_SPRITES} sprites")
    scenes = [render_scene(n_frames, hp, seed + k, h, w) for k in range(2)]
    sizes = torch.tensor([[w, h]] * 4, dtype=torch.int32)
    t = 0
    while True:
        images, boxes, ids = [], np.zeros((4, max_gt, 4), np.float32), \
            np.full((4, max_gt), -1, np.int32)
        for k, (frames, sboxes, sids) in enumerate(scenes):
            for d in range(2):
                row = 2 * k + d
                images.append(frames[t + d][0])
                boxes[row, :N_SPRITES] = sboxes[t + d]
                ids[row, :N_SPRITES] = sids[t + d] + k * N_SPRITES
        valid = np.zeros((4, max_gt), bool)
        valid[:, :N_SPRITES] = True
        gt = Boxes(boxes=torch.from_numpy(boxes),
                   scores=torch.from_numpy(valid.astype(np.float32)),
                   ids=torch.from_numpy(ids),
                   labels=torch.from_numpy(valid.astype(np.int32)),
                   valid=torch.from_numpy(valid))
        yield torch.from_numpy(np.stack(images)), gt, sizes
        t = (t + 1) % (n_frames - 1)


def public_detections(boxes, frame_wh, seed: int = 0,
                      scale_xy=(1.0, 1.0), drop: float = 0.1,
                      false_positives: int = 3) -> list:
    """Public detections of the sprites, per frame a list of
    ``data.motion_dataset.AnnoEntity`` in original-resolution xywh.

    boxes: per frame the sprite boxes [N, 4] (inclusive pixel corners,
    ``render_scene``) of a frame of ``frame_wh`` (w, h); scale_xy: the
    original resolution over the rendered one.  Each sprite box is
    jittered (centre by 3% and size by 5% of its extent, normal draws),
    about ``drop`` of them are dropped, ``false_positives`` person-sized
    boxes are added per frame; confidences in [0.3, 1] (false positives
    below 0.6).  The draws come from a ``torch.Generator`` seeded with
    ``seed``.
    """
    import torch

    from ..data.motion_dataset import AnnoEntity

    g = torch.Generator().manual_seed(seed)
    fw, fh = frame_wh
    sx, sy = scale_xy
    out = []
    for fb in boxes:
        fb = torch.as_tensor(np.asarray(fb), dtype=torch.float64)
        n = fb.shape[0]
        wh = fb[:, 2:] - fb[:, :2] + 1
        ctr = (fb[:, :2] + fb[:, 2:]) / 2 \
            + 0.03 * wh * torch.randn(n, 2, generator=g, dtype=torch.float64)
        wh = wh * torch.exp(0.05 * torch.randn(n, 2, generator=g,
                                               dtype=torch.float64))
        keep = torch.rand(n, generator=g, dtype=torch.float64) >= drop
        conf = 0.5 + 0.5 * torch.rand(n, generator=g, dtype=torch.float64)
        fp_h = fh * (0.12 + 0.3 * torch.rand(false_positives, generator=g,
                                             dtype=torch.float64))
        fp_wh = torch.stack([0.4 * fp_h, fp_h], -1)
        fp_ctr = torch.rand(false_positives, 2, generator=g,
                            dtype=torch.float64) \
            * torch.tensor([fw, fh], dtype=torch.float64)
        fp_conf = 0.3 + 0.3 * torch.rand(false_positives, generator=g,
                                         dtype=torch.float64)
        ctr = torch.cat([ctr[keep], fp_ctr])
        wh = torch.cat([wh[keep], fp_wh])
        conf = torch.cat([conf[keep], fp_conf])
        x1y1 = ctr - wh / 2
        frame = []
        for (x, y), (w, h), c in zip(x1y1.tolist(), wh.tolist(),
                                     conf.tolist()):
            e = AnnoEntity()
            e.bbox = [x * sx, y * sy, (w - 1) * sx + 1, (h - 1) * sy + 1]
            e.confidence, e.labels = c, {"person": c}
            frame.append(e)
        out.append(frame)
    return out
