"""Train data-loader builder (port of ``siammot_tpu.data.build``).

Per-key datasets (image or video by modality) concatenated, an
iteration-based shuffling sampler (no epochs) and a prefetching pool of
worker threads: the decode and the augmentation's C++ passes release the
GIL, so threads keep the host pipeline ahead of the step without
processes.  Each item carries its own seed, drawn from
``random.Random(f"{seed}/{iteration}")`` as the JAX loader draws it, so a
batch depends on (seed, iteration) alone: a run resumed at iteration k
loads what the uninterrupted run loaded.  The global batch is drawn on
every process and each loads its contiguous slice
(``process_index``/``process_count``, the JAX package's multi-host
sharding; one card is process 0 of 1).

Batches leave as the step takes them (``engine/trainer.py:do_train``):
uint8 images [B, H, W, 3] (in pinned memory for a card), gt
``core.structures.Boxes`` of [B, max_gt] tensors and int32 sizes [B, 2]
(w, h).
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch

from . import native
from .augmentation import build_siam_augmentation
from .data_utils import load_dataset_anno
from .datasets import (ClipCollator, ConcatDataset, ImageDataset,
                       VideoDataset)
from .filters import build_data_filter_fn

logger = logging.getLogger(__name__)


def build_dataset(cfg, device="cpu"):
    """``DATASETS.TRAIN``'s datasets, decoded and augmented on
    ``device``'s route."""
    datasets = []
    for key in cfg.DATASETS.TRAIN:
        anno, info = load_dataset_anno(cfg, key, set="train")
        transforms = build_siam_augmentation(cfg, is_train=True,
                                             modality=info["modality"],
                                             device=device)
        if info["modality"] == "image":
            datasets.append(ImageDataset(
                anno, info["image_folder"], transforms=transforms,
                frames_per_image=cfg.VIDEO.RANDOM_FRAMES_PER_CLIP,
                amodal=cfg.INPUT.AMODAL, device=device))
        else:
            datasets.append(VideoDataset(
                anno, sampling_interval=cfg.VIDEO.TEMPORAL_SAMPLING,
                clip_len=cfg.VIDEO.TEMPORAL_WINDOW,
                frames_in_clip=cfg.VIDEO.RANDOM_FRAMES_PER_CLIP,
                transforms=transforms,
                filter_fn=build_data_filter_fn(key, is_train=True),
                amodal=cfg.INPUT.AMODAL,
                dataset_root=info.get("dataset_root", ""), device=device))
    return ConcatDataset(datasets)


def to_tensors(batch, pin_memory: bool = False):
    """A collated batch (numpy) -> (images, gt Boxes, sizes) tensors, the
    images pinned when ``pin_memory``."""
    images, gt, sizes, _ = batch
    images = torch.from_numpy(images)
    if pin_memory:
        images = images.pin_memory()
    return images, gt.map(torch.from_numpy), torch.from_numpy(sizes)


class IterationLoader:
    """Infinite shuffled loader: yields (images, gt, sizes) batches.

    Deterministic given (seed, start_iter); every item carries its own
    seed so augmentation is reproducible regardless of worker timing.
    """

    def __init__(self, dataset, collator, batch_clips: int, max_iter: int,
                 num_workers: int = 4, seed: int = 0, start_iter: int = 0,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1, pin_memory: bool = False):
        self.dataset = dataset
        self.collator = collator
        self.batch_clips = batch_clips
        self.max_iter = max_iter
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.start_iter = start_iter
        self.prefetch = prefetch
        if batch_clips % process_count:
            raise ValueError(
                f"VIDEO_CLIPS_PER_BATCH={batch_clips} must divide evenly "
                f"over {process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.pin_memory = pin_memory

    def _indices_for(self, iteration: int):
        # the GLOBAL batch is drawn identically on every process (seeded
        # by iteration alone); each process loads only its contiguous
        # slice
        n = len(self.dataset)
        rng = random.Random(f"{self.seed}/{iteration}")
        idx = [(rng.randrange(n), rng.getrandbits(31))
               for _ in range(self.batch_clips)]
        per = self.batch_clips // self.process_count
        return idx[self.process_index * per:(self.process_index + 1) * per]

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            # keep `prefetch + 1` batches' ITEMS in flight at once:
            # submitting one batch at a time caps throughput at one
            # item-latency per batch (batch_clips may be < num_workers)
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending: deque = deque()
                it_next = self.start_iter
                depth = self.prefetch + 1
                try:
                    while pending or it_next < self.max_iter:
                        if stop.is_set():
                            return
                        while it_next < self.max_iter and \
                                len(pending) < depth:
                            pending.append([
                                pool.submit(self.dataset.__getitem__, idx)
                                for idx in self._indices_for(it_next)])
                            it_next += 1
                        futs = pending.popleft()
                        batch = self.collator([f.result() for f in futs])
                        q.put(to_tensors(batch, self.pin_memory))
                except BaseException as e:
                    q.put(e)
                    return
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # let the producer's blocked put finish and its pool wind down
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass


def build_train_data_loader(cfg, start_iter: int = 0, seed: int = 0,
                            device="cpu", process_index: int = 0,
                            process_count: int = 1) -> IterationLoader:
    """The training loader of ``cfg`` from ``start_iter``; on a card the
    frames decode there (nvJPEG) and the images leave in pinned memory."""
    device = torch.device(device)
    # build the route's libraries here, before the worker threads need them
    native.augment_library()
    if device.type == "cuda":
        native.nvjpeg_library()
    else:
        native.libjpeg_library()
    dataset = build_dataset(cfg, device)
    logger.info("train dataset: %d clips", len(dataset))
    static = None
    if cfg.TPU.INPUT_HEIGHT and cfg.TPU.INPUT_WIDTH:
        static = (cfg.TPU.INPUT_HEIGHT, cfg.TPU.INPUT_WIDTH)
    collator = ClipCollator(cfg.DATALOADER.SIZE_DIVISIBILITY,
                            max_gt=cfg.TPU.MAX_GT, static_size=static)
    return IterationLoader(dataset, collator,
                           batch_clips=cfg.SOLVER.VIDEO_CLIPS_PER_BATCH,
                           max_iter=cfg.SOLVER.MAX_ITER,
                           num_workers=cfg.DATALOADER.NUM_WORKERS,
                           seed=seed, start_iter=start_iter,
                           process_index=process_index,
                           process_count=process_count,
                           pin_memory=device.type == "cuda")
