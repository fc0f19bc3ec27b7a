"""Crowded synthetic 720p scene for driving the tracker (numpy only).

Own copy of ``bench.py:render_scene`` and of the ``Sprite``/``_texture``
renderer in ``tools/make_synth_mot.py``: textured person-shaped sprites
with constant-velocity-plus-noise motion over a smooth textured
background.  The random draws are the same, in the same order, as the
originals; ``cv2.resize`` is replaced by the numpy resizes below
(half-pixel bilinear, and nearest), which may differ from OpenCV's
fixed-point rounding by one grey level.
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
        x0, y0 = int(round(self.x)), int(round(self.y))
        bw, bh = max(2, int(round(self.w))), max(2, int(round(self.h)))
        x0 = min(max(x0, 0), frame.shape[1] - bw)
        y0 = min(max(y0, 0), frame.shape[0] - bh)
        tex = _resize_linear(self.tex, bw, bh)
        mask = _resize_nearest(self.mask, bw, bh)
        region = frame[y0:y0 + bh, x0:x0 + bw]
        region[mask] = tex[mask]


def render_scene(n_frames: int, hp: int, seed: int = 42,
                 h: int = H, w: int = W):
    """Crowded sprite scene: ``n_frames`` uint8 frames [1, hp, w, 3], the
    content in the top ``h`` rows and zeros below (the pad to the
    size-divisible input height)."""
    rng = np.random.RandomState(seed)
    bg = _texture(rng, h, w, scale=16)
    sprites = []
    for i in range(N_SPRITES):
        s = Sprite(rng, i + 1, w, 384)
        s.y = rng.uniform(0, h - s.h)
        sprites.append(s)
    frames = []
    for _ in range(n_frames):
        f = bg.copy()
        for s in sorted(sprites, key=lambda s: s.h):
            s.draw(f)
        for s in sprites:
            s.step(rng, w, h)
        out = np.zeros((1, hp, w, 3), np.uint8)
        out[0, :h] = f
        frames.append(out)
    return frames
