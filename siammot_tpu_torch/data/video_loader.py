"""Frame sources for dataset inference (own copy of
``siammot_tpu.data.video_loader``, without ``cv2``).

Image folders of JPEG frames, the layout of MOT17, SYNMOT and the
ingested datasets, decode with the port's frame reader
(``data/native.py``: libjpeg on the CPU, nvJPEG on the card) on a
background prefetch thread that overlaps decoding with the device's step.
Video files and other image formats have no reader in the port: the JAX
package reads them with ``cv2``, which the port does not use, so they
raise.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from . import native

JPEG_EXTS = (".jpg", ".jpeg")
IMAGE_EXTS = JPEG_EXTS + (".png", ".bmp")


def _no_reader(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: the port reads folders of JPEG frames only (libjpeg on "
        f"the CPU, nvJPEG on the card); "
        f"video files and other image formats need a reader it does not "
        f"have yet (the JAX package uses cv2 for them)")


def jpeg_files(path: str) -> list:
    """The frames of an image folder, in name order; raises if the folder
    holds other images or no JPEG."""
    files = sorted(f for f in glob.glob(os.path.join(path, "*"))
                   if f.lower().endswith(IMAGE_EXTS))
    if not files or not all(f.lower().endswith(JPEG_EXTS) for f in files):
        raise _no_reader(path)
    return files


def folder_frames(path: str, device="cpu") -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames from a directory of numbered JPEGs, decoded
    on ``device``'s route (``native.FrameReader``)."""
    reader = native.FrameReader(device)
    for f in jpeg_files(path):
        yield reader.decode(f, *native.image_size(f))


def video_metadata(path: str) -> dict:
    """(fps, frame count, width, height) of an image folder."""
    if not os.path.isdir(path):
        raise _no_reader(path)
    files = jpeg_files(path)
    w, h = native.image_size(files[0])
    return dict(fps=30.0, number_of_frames=len(files),
                resolution={"width": w, "height": h})


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
    """Prefetched stream of ``(padded [1, H, W, 3], (w, h))`` for a JPEG
    folder, decoded on ``device``'s route (``native.FrameReader``): uint8
    with ``transform.device_normalize``, else normalised float32 (resize
    and normalisation as the JAX package's native path does them)."""
    if not os.path.isdir(path):
        raise _no_reader(path)
    files = jpeg_files(path)
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
