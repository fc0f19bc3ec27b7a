"""MOT17 / MOT15 ingestion (own copy of
``siammot_tpu.data.ingestion.ingest_mot``): converts raw MOTChallenge
sequences (``seqinfo.ini`` + ``gt/gt.txt`` or ``det/det.txt``)
into the MotionDataset JSON layout (anno.json + splits.json), with
per-entity time in ms, visibility and the MOT label map.

Usage:
  python -m siammot_tpu_torch.data.ingestion.ingest_mot \
      --root <dataset_root_with_train/test_dirs> [--anno-name anno.json]
"""

from __future__ import annotations

import argparse
import configparser
import csv
import glob
import os

from .. import imageio
from ..motion_dataset import AnnoEntity, DataSample, MotionDataset

MOT_LABEL_MAP = {
    1: "person", 2: "person_on_vehicle", 3: "car", 4: "bicycle",
    5: "motorbike", 6: "non_mot_vehicle", 7: "static_person",
    8: "distractor", 9: "occluder", 10: "occluder_on_ground",
    11: "occluder_full", 12: "reflection",
}


def read_seqinfo(seq_dir: str) -> dict:
    """Sequence metadata from ``seqinfo.ini``, or probed from the images.

    MOT15-style sequences ship no ``seqinfo.ini``; the reference's
    non-MOT17 branch (``ingest_mot.py:137-146``) assumes 30 fps, counts
    the jpgs for the frame total, and reads width/height off the first
    frame.  Same here, through the port's still reader
    (``data/imageio.py``: the size ``cv2.imread`` gives, turned by the
    EXIF orientation).
    """
    ini = os.path.join(seq_dir, "seqinfo.ini")
    if os.path.exists(ini):
        cp = configparser.ConfigParser()
        cp.read(ini)
        s = cp["Sequence"]
        return dict(
            name=s.get("name", os.path.basename(seq_dir)),
            fps=float(s.get("frameRate", 30)),
            num_frames=int(s.get("seqLength", 0)),
            width=int(s.get("imWidth", 0)),
            height=int(s.get("imHeight", 0)),
            im_dir=s.get("imDir", "img1"),
            im_ext=s.get("imExt", ".jpg"),
        )
    im_paths = sorted(glob.glob(os.path.join(seq_dir, "img1", "*.jpg")))
    width = height = 0
    if im_paths:
        width, height = imageio.image_size(im_paths[0])
    return dict(
        name=os.path.basename(seq_dir),
        fps=30.0,
        num_frames=len(im_paths),
        width=width,
        height=height,
        im_dir="img1",
        im_ext=".jpg",
    )


def parse_mot_csv(path: str, fps: float, is_gt: bool) -> list:
    """gt.txt rows: frame,id,x,y,w,h,conf,class,visibility;
    det.txt rows: frame,id(-1),x,y,w,h,conf[,...]."""
    entities = []
    if not os.path.exists(path):
        return entities
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) < 7:
                continue
            frame = int(float(row[0]))
            eid = int(float(row[1]))
            x, y, w, h = map(float, row[2:6])
            conf = float(row[6])
            e = AnnoEntity(time=(frame - 1) * 1000.0 / fps, id=eid)
            e.bbox = [x, y, w, h]
            e.confidence = conf
            e.blob = {"frame_idx": frame - 1}
            if is_gt and len(row) >= 9:
                cls = int(float(row[7]))
                e.labels = {MOT_LABEL_MAP.get(cls, str(cls)): 1}
                e.blob["visibility"] = float(row[8])
            else:
                e.labels = {"person": 1}
            entities.append(e)
    return entities


def ingest_sequence(seq_dir: str, source: str = "gt",
                    root: str = None) -> DataSample:
    info = read_seqinfo(seq_dir)
    # data_path is stored relative to the dataset root so
    # ``resolve_data_path`` can join them (e.g. "train/MOT17-04-DPM/img1")
    rel = os.path.join(os.path.relpath(seq_dir, root) if root
                       else os.path.basename(seq_dir), info["im_dir"])
    sample = DataSample(info["name"], metadata=dict(
        fps=info["fps"],
        number_of_frames=info["num_frames"],
        resolution={"width": info["width"], "height": info["height"]},
        data_path=rel,
    ))
    anno = os.path.join(seq_dir, source, f"{source}.txt")
    for e in parse_mot_csv(anno, info["fps"], is_gt=(source == "gt")):
        sample.add_entity(e)
    return sample


def ingest_mot(root: str, anno_name: str = "anno.json",
               det_anno_name: str = "anno_pub_detection.json") -> None:
    """Ingest <root>/{train,test}/<seq>/ into MotionDataset JSONs."""
    ds = MotionDataset(anno_file=anno_name, root_path=root, split_file=None)
    det_ds = MotionDataset(anno_file=det_anno_name, root_path=root,
                           split_file=None)
    splits = {"train": [], "test": []}
    for split in ("train", "test"):
        for seq_dir in sorted(glob.glob(os.path.join(root, split, "*"))):
            if not os.path.isdir(seq_dir):
                continue
            sample = ingest_sequence(seq_dir, source="gt", root=root)
            ds.add_sample(sample)
            splits[split].append(sample.id)
            det = ingest_sequence(seq_dir, source="det", root=root)
            if det.entities:
                det_ds.add_sample(det)
    ds.metadata = {"description": "MOTChallenge ingestion"}
    ds.dump()
    ds.dump_splits(splits)
    if det_ds.samples:
        det_ds.dump()
    print(f"ingested {len(ds)} sequences -> {ds.anno_path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--anno-name", default="anno.json")
    args = ap.parse_args()
    ingest_mot(args.root, args.anno_name)


if __name__ == "__main__":
    main()
