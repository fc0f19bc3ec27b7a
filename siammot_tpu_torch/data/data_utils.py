"""Annotation loading helpers (own copy of ``siammot_tpu.data.data_utils``)
on top of the MotionDataset / CocoDataset readers.
"""

from __future__ import annotations

import logging
import os

from .coco import CocoDataset
from .dataset_info import dataset_maps
from .motion_dataset import MotionDataset

logger = logging.getLogger(__name__)


def load_dataset_anno(cfg, dataset_key: str, set: str = None):
    """Returns (dataset, info) — a list of (id, DataSample) pairs for video
    datasets (optionally restricted to a split) or a CocoDataset for image
    datasets (info carries the image folder)."""
    folder, anno_file, split_file, modality = dataset_maps[dataset_key]
    folder = os.path.join(cfg.DATASETS.ROOT_DIR, folder)
    info = {"modality": modality, "dataset_folder": folder}

    if modality == "video":
        ds = MotionDataset(anno_file, root_path=folder, split_file=split_file)
        info["dataset_root"] = ds.data_root_path
        samples = ds.get_split(set or "train") if set else list(ds)
        return samples, info

    dataset = CocoDataset(os.path.join(folder, anno_file))
    info["image_folder"] = os.path.join(folder, split_file)
    return dataset, info


def load_public_detection(cfg, dataset_key: str):
    """MOT17 public-detection annotations (``anno_pub_detection.json``);
    returns {sample_id: DataSample} or None when not ingested
    (the reference's ``data_utils.py:64-79``)."""
    folder, _, split_file, _ = dataset_maps[dataset_key]
    folder = os.path.join(cfg.DATASETS.ROOT_DIR, folder)
    ds = MotionDataset("anno_pub_detection.json", root_path=folder,
                       split_file=split_file)
    if not len(ds):
        logger.warning("public detection not ingested under %s", folder)
        return None
    return dict(ds)
