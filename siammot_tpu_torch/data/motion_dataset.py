"""Video-annotation data model (own copy of
``siammot_tpu.data.motion_dataset``).

The ``GluonCVMotionDataset / DataSample / AnnoEntity`` data model that
ingestion, inference I/O and evaluation share.  The JSON layout is the
JAX package's, so annotations, splits and prediction caches written by
either package load in the other: an
``anno.json`` with a ``samples`` map of per-video ``{metadata, entities}``,
entities carrying ``time`` (ms), ``bbox`` (xywh), ``confidence``, ``id``
and a ``labels`` map, plus a ``splits.json`` assigning sample ids to
train/val/test.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional


class AnnoEntity:
    """One box annotation / prediction at one video time."""

    def __init__(self, time: float = 0.0, id: int = -1):
        self.time = time          # milliseconds
        self.id = id
        self.bbox = None          # [x, y, w, h]
        self.confidence = 1.0
        self.labels = {}          # {class_name_or_id: score}
        self.blob = {}            # free-form extras (frame_idx, visibility…)

    @property
    def frame_num(self):
        return self.blob.get("frame_idx")

    def to_dict(self) -> dict:
        d = {"time": self.time, "id": self.id, "confidence": self.confidence,
             "labels": self.labels}
        if self.bbox is not None:
            d["bbox"] = list(map(float, self.bbox))
        if self.blob:
            d["blob"] = self.blob
        return d

    @staticmethod
    def from_dict(d: dict) -> "AnnoEntity":
        e = AnnoEntity(time=d.get("time", 0.0), id=d.get("id", -1))
        e.bbox = d.get("bbox")
        e.confidence = d.get("confidence", 1.0)
        e.labels = d.get("labels", {})
        e.blob = d.get("blob", {})
        return e


class DataSample:
    """One video with metadata + a time-ordered entity list."""

    def __init__(self, sample_id: str, metadata: Optional[dict] = None,
                 raw_info=None):
        self.id = sample_id
        self.metadata = metadata or {}
        self.entities: list[AnnoEntity] = []
        self._frame_index: Optional[dict] = None

    # -- metadata accessors --------------------------------------------------
    @property
    def fps(self) -> float:
        return self.metadata.get("fps", 30.0)

    @property
    def width(self) -> int:
        return self.metadata.get("resolution", {}).get("width",
                                                       self.metadata.get("width", 0))

    @property
    def height(self) -> int:
        return self.metadata.get("resolution", {}).get("height",
                                                       self.metadata.get("height", 0))

    @property
    def data_path(self) -> str:
        return self.metadata.get("data_path", "")

    def __len__(self) -> int:
        return int(self.metadata.get("number_of_frames", 0))

    # -- entities ------------------------------------------------------------
    def add_entity(self, entity: AnnoEntity) -> None:
        self.entities.append(entity)
        self._frame_index = None

    def frame_num_of(self, entity: AnnoEntity) -> int:
        if entity.frame_num is not None:
            return int(entity.frame_num)
        return int(round(entity.time / 1000.0 * self.fps))

    def _build_frame_index(self):
        if self._frame_index is None:
            self._frame_index = {}
            for e in self.entities:
                self._frame_index.setdefault(self.frame_num_of(e), []).append(e)
        return self._frame_index

    def get_entities_for_frame_num(self, frame_num: int) -> list:
        return self._build_frame_index().get(int(frame_num), [])

    def get_entities_with_id(self, eid: int) -> list:
        return [e for e in self.entities if e.id == eid]

    def get_copy_without_entities(self) -> "DataSample":
        return DataSample(self.id, metadata=dict(self.metadata))

    def get_non_empty_frames(self, filter_fn=None) -> list:
        """Frame indices that carry at least one (filtered) entity."""
        frames = set()
        for e in self.entities:
            if filter_fn is None or filter_fn(e):
                frames.add(self.frame_num_of(e))
        return sorted(frames)

    # -- I/O -----------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"metadata": self.metadata,
                "entities": [e.to_dict() for e in self.entities]}

    @staticmethod
    def from_dict(sample_id: str, d: dict) -> "DataSample":
        s = DataSample(sample_id, metadata=d.get("metadata", {}))
        for ed in d.get("entities", []):
            s.add_entity(AnnoEntity.from_dict(ed))
        return s

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"id": self.id, **self.to_dict()}, f)

    @staticmethod
    def load(path: str) -> "DataSample":
        with open(path) as f:
            d = json.load(f)
        return DataSample.from_dict(d.get("id", os.path.basename(path)), d)


class MotionDataset:
    """A GluonCVMotionDataset-compatible collection of DataSamples.

    Layout: <root>/<annotation>/anno.json (+ splits.json), videos/frames
    under <root>/<data_dir>.
    """

    ANNO_DIR = "annotation"
    DATA_DIR = "raw_data"

    def __init__(self, anno_file: str = "anno.json", root_path: str = "",
                 split_file: Optional[str] = "splits.json"):
        self.root_path = root_path
        self.anno_path = os.path.join(root_path, self.ANNO_DIR, anno_file)
        self.samples: dict[str, DataSample] = {}
        self.metadata: dict = {}
        self.splits: dict = {}

        if os.path.exists(self.anno_path):
            with open(self.anno_path) as f:
                d = json.load(f)
            self.metadata = d.get("metadata", {})
            for sid, sd in d.get("samples", {}).items():
                self.samples[sid] = DataSample.from_dict(sid, sd)

        if split_file:
            sp = os.path.join(root_path, self.ANNO_DIR, split_file)
            if os.path.exists(sp):
                with open(sp) as f:
                    self.splits = json.load(f)

    @property
    def data_root_path(self) -> str:
        return os.path.join(self.root_path, self.DATA_DIR)

    def add_sample(self, sample: DataSample) -> None:
        self.samples[sample.id] = sample

    def get_split(self, split: str) -> list:
        ids = self.splits.get(split, sorted(self.samples))
        return [(sid, self.samples[sid]) for sid in ids if sid in self.samples]

    def __iter__(self) -> Iterator:
        return iter(sorted(self.samples.items()))

    def __len__(self) -> int:
        return len(self.samples)

    def dump(self) -> None:
        os.makedirs(os.path.dirname(self.anno_path), exist_ok=True)
        with open(self.anno_path, "w") as f:
            json.dump({"metadata": self.metadata,
                       "samples": {sid: s.to_dict()
                                   for sid, s in self.samples.items()}}, f)

    def dump_splits(self, splits: dict) -> None:
        self.splits = splits
        path = os.path.join(os.path.dirname(self.anno_path), "splits.json")
        with open(path, "w") as f:
            json.dump(splits, f)
