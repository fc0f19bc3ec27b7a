"""Frame sources for dataset inference and the demo (own copy of
``siammot_tpu.data.video_loader``, without ``cv2``).

  * Image folders: every still in ``IMAGE_EXTS`` in name order, read by
    ``data/imageio.py`` (JPEG on ``device``'s route, PNG, BMP; EXIF
    orientation applied, as ``cv2.imread`` applies it).
  * Video files: Motion JPEG in AVI, MP4 or MOV, demuxed by
    ``data/container.py`` and decoded on ``device``'s route, turned upright
    by the container's rotation as OpenCV turns them by default.  Other
    codecs raise ``NotImplementedError`` naming the codec: the card's
    machine has no decoder for them.

:func:`normalized_frame_source` takes the JAX package's fast path over a
folder holding JPEGs: the port's frame reader (``data/native.py``: libjpeg
on the CPU, nvJPEG on the card) over its JPEG files only, raw (no EXIF
orientation, as the JAX package's native reader), on a background prefetch
thread that overlaps decoding with the device's step; each source owns its
reader (on the card an nvJPEG handle and a CUDA stream of its own), so the
multi-stream engine's S sources decode at once.  Every other source
decodes on the prefetch thread and runs ``transform`` on each frame.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from . import imageio, native
from .container import open_video

JPEG_EXTS = (".jpg", ".jpeg")
IMAGE_EXTS = JPEG_EXTS + (".png", ".bmp")


def image_files(path: str) -> list:
    """The stills of an image folder (``IMAGE_EXTS``), in name order."""
    return sorted(f for f in glob.glob(os.path.join(path, "*"))
                  if f.lower().endswith(IMAGE_EXTS))


def jpeg_files(path: str) -> list:
    """The JPEG files of an image folder, in name order (the JAX package's
    fast path reads these and ignores the folder's other images)."""
    return [f for f in image_files(path) if f.lower().endswith(JPEG_EXTS)]


def video_frames(path: str, device="cpu") -> Iterator[np.ndarray]:
    """Yield upright RGB uint8 frames from a video file."""
    return open_video(path).frames(device)


def folder_frames(path: str, device="cpu") -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames from a directory of numbered images."""
    for f in image_files(path):
        yield imageio.imread(f, device)


def build_frame_iterator(path: str, device="cpu") -> Iterator[np.ndarray]:
    if os.path.isdir(path):
        return folder_frames(path, device)
    return video_frames(path, device)


def video_metadata(path: str) -> dict:
    """(fps, frame count, width, height) for a file or image folder."""
    if os.path.isdir(path):
        files = image_files(path)
        if not files:
            return dict(fps=30.0, number_of_frames=0)
        w, h = imageio.image_size(files[0])
        return dict(fps=30.0, number_of_frames=len(files),
                    resolution={"width": w, "height": h})
    return open_video(path).metadata()


class PrefetchIterator:
    """Run a frame iterator + transform on a background thread."""

    _DONE = object()

    def __init__(self, iterator, transform=None, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, args=(iterator,),
                                   daemon=True)
        self._t.start()

    def _run(self, iterator):
        try:
            for item in iterator:
                self._q.put(self._transform(item) if self._transform else item)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def normalized_frame_source(path: str, transform, depth: int = 4,
                            device="cpu"):
    """Prefetched stream of ``(padded [1, H, W, 3], (w, h))``: uint8 with
    ``transform.device_normalize``, else normalised float32.

    A folder holding JPEGs takes the native route over its JPEG files
    (``native.FrameReader`` on ``device``'s route; resize and
    normalisation as the JAX package's native path does them); everything
    else decodes on the prefetch thread and runs ``transform`` per frame.
    """
    files = jpeg_files(path) if os.path.isdir(path) else []
    if not files:
        return PrefetchIterator(build_frame_iterator(path, device),
                                transform, depth)
    nw, nh = transform.input_size(*native.image_size(files[0]))
    if not transform.device_normalize and transform.to_bgr255:
        raise ValueError("INPUT.TO_BGR255 with TPU.DEVICE_NORMALIZE False: "
                         "the reader's float path normalises RGB / 255 only")
    reader = native.FrameReader(device)

    def gen():
        from .transforms import pad_to_divisible
        for f in files:
            x = reader.decode(f, nw, nh) if transform.device_normalize \
                else reader.decode_normalize(f, nw, nh, transform.mean,
                                             transform.std)
            yield pad_to_divisible(x, transform.divisor)[None], (nw, nh)

    return PrefetchIterator(gen(), None, depth)


def resolve_data_path(sample, dataset_root: str) -> str:
    """Locate a sample's frame source under the dataset root."""
    p = sample.data_path
    if not p:
        raise IOError(f"sample {sample.id} has no data_path")
    if os.path.isabs(p):
        return p
    cand = os.path.join(dataset_root, p)
    if os.path.exists(cand):
        return cand
    # ingested MOT layouts keep raw sequences beside the annotation dir
    # rather than under <root>/raw_data: fall back to the dataset folder
    if os.path.basename(dataset_root) == "raw_data":
        alt = os.path.join(os.path.dirname(dataset_root), p)
        if os.path.exists(alt):
            return alt
    return cand
