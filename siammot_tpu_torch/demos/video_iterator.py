"""Frame sources for the demo (counterpart of ``demos/video_iterator.py``,
without ``cv2``).  Each yields ``(frame_id, RGB uint8 frame)`` pairs and
has ``fps`` and ``frame_count``.

  * An image folder: every still in ``IMAGE_EXTS`` in name order, read by
    ``data/imageio.py`` (EXIF orientation applied, as ``cv2.imread``
    applies it); 30 fps.
  * A video file: Motion JPEG, H.264, HEVC, MPEG-4 Part 2, VP8, VP9 or
    AV1 in AVI, MP4, MOV, Matroska or WebM (``data/container.py``,
    ``data/matroska.py``), each frame turned upright by the container's
    rotation with :func:`apply_rotation`, the JAX demo's ``np.rot90``
    rule; the rotation is read from ``tkhd``'s display matrix or
    Matroska's ``ProjectionPoseRoll`` where the JAX demo asks OpenCV's
    FFmpeg backend for it.  Other codecs raise ``NotImplementedError``
    naming the codec.

Frames decode on ``device``'s route: JPEG with libjpeg on the CPU and
nvJPEG on the card, the other codecs with NVDEC on the card only (the
CPU raises).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from ..data import imageio
from ..data.container import apply_rotation, open_video
from ..data.video_loader import IMAGE_EXTS, image_files

__all__ = ["IMAGE_EXTS", "ContainerIterator", "ImageFolderIterator",
           "apply_rotation", "build_video_iterator", "check_rotation"]


def check_rotation(path: str) -> int:
    """The container's rotation in degrees (0/90/180/270)."""
    return open_video(path).rotation


class ContainerIterator:
    def __init__(self, path: str, device="cpu"):
        self.path = path
        self.device = device
        self.video = open_video(path)
        self.rotation = self.video.rotation
        self.fps = self.video.fps or 30.0
        # CAP_PROP_FRAME_COUNT's count, as the JAX demo reads it
        self.frame_count = self.video.metadata()["number_of_frames"]

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        return enumerate(self.video.frames(self.device))


class ImageFolderIterator:
    def __init__(self, path: str, device="cpu"):
        self.files = image_files(path)
        if not self.files:
            raise IOError(f"no images under {path}")
        self.device = device
        self.fps = 30.0
        self.frame_count = len(self.files)

    def __iter__(self):
        for i, f in enumerate(self.files):
            yield i, imageio.imread(f, self.device)


def build_video_iterator(path: str, device="cpu"):
    """Counterpart of ``build_video_iterator`` of the JAX demo."""
    if os.path.isdir(path):
        return ImageFolderIterator(path, device)
    return ContainerIterator(path, device)
