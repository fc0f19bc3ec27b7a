"""Training datasets: real video clips and images-as-video (port of
``siammot_tpu.data.datasets``, without ``cv2``).

  * ``VideoDataset``: sliding-window clip index over ingested
    MotionDataset videos (window ``VIDEO.TEMPORAL_WINDOW`` ms, stride
    ``VIDEO.TEMPORAL_SAMPLING`` ms), each item sampling 2 annotated frames
    in temporal order.
  * ``ImageDataset``: COCO-format detection data as fake video, each image
    duplicated ``frames_per_image`` times, the synthetic-motion
    augmentation faking inter-frame motion; the reference's label hygiene
    (dedupe boxes, min area, crowd skip, amodal clipping).

``ClipCollator`` pads a batch into fixed-capacity arrays: images to a
static (or batch-max, divisible) shape, gt to ``max_gt`` slots with a
validity mask, instance ids remapped to batch-unique uids, as the JAX
collator does.

Frames are read at their own size as the JAX package's ``cv2.imread``
reads them: stills through ``data/imageio.py`` (JPEG on ``device``'s
route: libjpeg on the CPU, whose bytes are ``cv2.imread``'s, or the
calling thread's own nvJPEG decoder on the card; PNG; BMP; EXIF
orientation applied), and a video sample's frames by index from an MJPEG
AVI, MP4 or MOV (``data/container.py``; other codecs raise
``NotImplementedError``).
"""

from __future__ import annotations

import bisect
import logging
import os
import random

import numpy as np

from ..core.structures import Boxes
from . import imageio
from .coco import CocoDataset
from .container import apply_rotation, open_video
from .motion_dataset import MotionDataset
from .target import FrameTarget
from .video_loader import image_files, resolve_data_path

logger = logging.getLogger(__name__)


class FrameReader:
    """Random access to a video sample's frames (image folder or video
    file), decoded on ``device``'s route."""

    def __init__(self, path: str, device="cpu"):
        self.path = path
        self.device = device
        self.is_dir = os.path.isdir(path)
        if self.is_dir:
            self.files = image_files(path)
        else:
            self.video = open_video(path)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self.is_dir:
            return imageio.imread(self.files[idx], self.device)
        if not 0 <= idx < self.video.frame_count:
            raise IOError(f"cannot seek frame {idx} of {self.path}")
        return apply_rotation(self.video.frame(idx, self.device),
                              self.video.rotation)


class VideoDataset:
    """Sliding-window clips of annotated video (train only)."""

    def __init__(self, dataset, sampling_interval=250,
                 clip_len=1000, frames_in_clip=2, transforms=None,
                 filter_fn=None, amodal=False, dataset_root="",
                 device="cpu"):
        """``dataset``: a MotionDataset, or a list/dict of (id, DataSample)
        train samples (as returned by ``load_dataset_anno``); ``device``:
        the decoder's route."""
        assert 0 < frames_in_clip <= 2
        if isinstance(dataset, MotionDataset):
            self.data = dict(dataset.get_split("train"))
            dataset_root = dataset_root or dataset.data_root_path
        else:
            self.data = dict(dataset)
        self.transforms = transforms
        self.filter_fn = filter_fn
        self.frames_in_clip = min(clip_len, frames_in_clip)
        self.amodal = amodal
        self.dataset_root = dataset_root
        self.device = device
        self.clips = self._index_clips(sampling_interval, clip_len)
        self._readers: dict = {}

    def _index_clips(self, sampling_interval_ms, clip_len_ms):
        """Reference ``get_video_clips`` (``video_dataset.py:79-105``)."""
        clips = []
        for sample_id, sample in self.data.items():
            frames_with_anno = sample.get_non_empty_frames(
                None if self.filter_fn is None
                else lambda e: len(self.filter_fn([e])[0]) > 0)
            if not frames_with_anno:
                continue
            anno_set = set(frames_with_anno)
            clip_frames = max(self.frames_in_clip,
                              int(clip_len_ms / 1000.0 * sample.fps))
            stride = max(1, int(sampling_interval_ms / 1000.0 * sample.fps))
            for start in range(min(frames_with_anno),
                               max(frames_with_anno), stride):
                ids = [f for f in range(start, start + clip_frames)
                       if f in anno_set]
                if len(ids) >= self.frames_in_clip:
                    clips.append((sample_id, ids))
        return clips

    def __len__(self):
        return len(self.clips)

    def _reader(self, sample) -> FrameReader:
        if sample.id not in self._readers:
            self._readers[sample.id] = FrameReader(
                resolve_data_path(sample, self.dataset_root), self.device)
        return self._readers[sample.id]

    def _entities_to_target(self, entities, size) -> FrameTarget:
        if self.filter_fn is not None:
            entities, _ = self.filter_fn(entities)
        if not entities:
            return FrameTarget.empty(size)
        # labels forced to 1 = person (reference video_dataset.py:113-116)
        t = FrameTarget.from_xywh([e.bbox for e in entities],
                                  [int(e.id) for e in entities],
                                  [1] * len(entities), size)
        if not self.amodal:
            t = t.clip_to_image(remove_empty=False)
        return t

    def __getitem__(self, item):
        rng = random.Random() if not isinstance(item, tuple) else \
            random.Random(item[1])
        idx = item if not isinstance(item, tuple) else item[0]
        sample_id, clip_frame_ids = self.clips[idx]
        sample = self.data[sample_id]
        reader = self._reader(sample)

        frames, targets = [], []
        for frame_idx in sorted(rng.sample(clip_frame_ids,
                                           self.frames_in_clip)):
            img = reader[frame_idx]
            size = (img.shape[1], img.shape[0])
            entities = sample.get_entities_for_frame_num(frame_idx)
            frames.append(img)
            targets.append(self._entities_to_target(entities, size))

        if self.transforms is not None:
            frames, targets = self.transforms(frames, targets, rng)
        return frames, targets, sample_id


class ImageDataset:
    """COCO-format detection images as 2-frame pseudo-video clips."""

    def __init__(self, dataset: CocoDataset, image_dir, transforms=None,
                 frames_per_image=2, amodal=False, skip_empty=True,
                 min_object_area=0, use_crowd=False, device="cpu"):
        self.dataset = dataset
        self.device = device
        self.image_dir = image_dir
        self.transforms = transforms
        self.frames_per_image = frames_per_image
        self._amodal = amodal
        self._skip_empty = skip_empty
        self._min_object_area = min_object_area
        self._use_crowd = use_crowd
        self.classes = [c["name"] for c in
                        dataset.load_cats(dataset.get_cat_ids())]
        self._cat_to_contiguous = {
            v: i + 1 for i, v in enumerate(dataset.get_cat_ids())}
        self._labels, self._items = self._preprocess()

    def _check_load_bbox(self, entry, instance_id):
        """Label hygiene (reference ``image_dataset.py:130-180``): skip
        ignore/crowd, dedupe exact boxes, min-area filter, amodal-aware
        clipping; emits (x1, y1, x2, y2, class, instance_id) rows."""
        w, h = entry["width"], entry["height"]
        valid, seen = [], set()
        count = 0
        for obj in self.dataset.anns_for_img(entry["id"]):
            if obj.get("ignore", 0) == 1:
                continue
            if not self._use_crowd and obj.get("iscrowd", 0):
                continue
            x, y, bw, bh = obj["bbox"]
            xmin, ymin = x, y
            xmax, ymax = x + max(bw - 1, 0), y + max(bh - 1, 0)
            if not self._amodal:
                xmin = min(max(xmin, 0), w - 1)
                ymin = min(max(ymin, 0), h - 1)
                xmax = min(max(xmax, 0), w - 1)
                ymax = min(max(ymax, 0), h - 1)
            if (xmin, ymin, xmax, ymax) in seen:
                continue
            if (xmax - xmin) * (ymax - ymin) <= self._min_object_area:
                continue
            if xmax > xmin and ymax > ymin:
                seen.add((xmin, ymin, xmax, ymax))
                valid.append([xmin, ymin, xmax, ymax,
                              self._cat_to_contiguous[obj["category_id"]],
                              instance_id + count])
                count += 1
        return valid, count

    def _preprocess(self):
        labels, items = [], []
        instance_id = 0
        for entry in self.dataset.load_imgs(self.dataset.get_img_ids()):
            label, n = self._check_load_bbox(entry, instance_id)
            if not label and self._skip_empty:
                continue
            instance_id += n
            labels.append(label)
            items.append((entry["file_name"],
                          (entry["width"], entry["height"])))
        logger.info("%d valid images, %d instances", len(items), instance_id)
        return labels, items

    def __len__(self):
        return len(self._items)

    def __getitem__(self, item):
        rng = random.Random() if not isinstance(item, tuple) else \
            random.Random(item[1])
        idx = item if not isinstance(item, tuple) else item[0]
        file_name, size = self._items[idx]
        img = imageio.imread(os.path.join(self.image_dir, file_name),
                             self.device)

        rows = np.asarray(self._labels[idx], np.float32).reshape(-1, 6)
        target = FrameTarget(boxes=rows[:, :4].astype(np.float32),
                             ids=rows[:, 5].astype(np.int64),
                             labels=rows[:, 4].astype(np.int64), size=size)
        frames = [img] * self.frames_per_image
        targets = [target] * self.frames_per_image
        if self.transforms is not None:
            frames, targets = self.transforms(frames, targets, rng)
        return frames, targets, file_name


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1] if self.cum else 0

    def __getitem__(self, item):
        idx, seed = item if isinstance(item, tuple) else (item, None)
        di = bisect.bisect_right(self.cum, idx)
        base = self.cum[di - 1] if di > 0 else 0
        inner = idx - base
        return self.datasets[di][(inner, seed) if seed is not None else inner]


class ClipCollator:
    """Batch clips into fixed-capacity arrays.

    Returns (images [B*F, H, W, 3] in the frames' dtype, gt ``Boxes`` with
    [B*F, max_gt] fields, sizes [B*F, 2] (w, h), video ids), all numpy:
    the JAX collator's arrays (``data.build.to_tensors`` makes the step's
    tensors of them).  Instance ids are remapped to batch-unique uids (the
    reference's ``VideoDatasetBatchCollator``) so the track-pair sampler
    can match identities by equality across frames.
    """

    def __init__(self, size_divisibility=32, max_gt=100, static_size=None):
        self.divisor = size_divisibility or 32
        self.max_gt = max_gt
        self.static_size = static_size  # optional (H, W) compile shape

    def __call__(self, batch):
        frames = [f for clip, _, _ in batch for f in clip]
        targets = [t for _, clip_t, _ in batch for t in clip_t]
        video_ids = [vid for _, _, vid in batch]

        if self.static_size is not None:
            mh, mw = self.static_size
        else:
            mh = max(f.shape[0] for f in frames)
            mw = max(f.shape[1] for f in frames)
            mh = -(-mh // self.divisor) * self.divisor
            mw = -(-mw // self.divisor) * self.divisor
        # dtype-preserving: uint8 frames (device-side normalization) ship
        # 4x less data than normalized f32
        images = np.zeros((len(frames), mh, mw, 3), frames[0].dtype)
        sizes = np.zeros((len(frames), 2), np.int32)
        for i, f in enumerate(frames):
            images[i, :f.shape[0], :f.shape[1]] = f
            sizes[i] = (f.shape[1], f.shape[0])            # (w, h)

        # batch-unique uid remap, consistent within each video's clip
        uid = 0
        uid_maps: dict = {}
        n, g = len(frames), self.max_gt
        boxes = np.zeros((n, g, 4), np.float32)
        ids = np.full((n, g), -1, np.int32)
        labels = np.zeros((n, g), np.int32)
        valid = np.zeros((n, g), bool)
        frames_per_clip = len(batch[0][0]) if batch else 1
        for i, t in enumerate(targets):
            vid = video_ids[i // frames_per_clip]
            vmap = uid_maps.setdefault(vid, {})
            k = min(len(t), g)
            if len(t) > g:
                logger.warning("frame has %d gt > capacity %d; truncating",
                               len(t), g)
            boxes[i, :k] = t.boxes[:k]
            labels[i, :k] = t.labels[:k]
            valid[i, :k] = True
            for j in range(k):
                tid = int(t.ids[j])
                if tid not in vmap:
                    vmap[tid] = uid
                    uid += 1
                ids[i, j] = vmap[tid]

        gt = Boxes(boxes=boxes, scores=np.ones((n, g), np.float32), ids=ids,
                   labels=labels, valid=valid)
        return images, gt, sizes, video_ids
