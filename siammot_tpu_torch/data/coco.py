"""Minimal COCO-format annotation reader (own copy of
``siammot_tpu.data.coco``).

The ``pycocotools.COCO`` surface SiamMOT consumes: image listing, per-image
annotation lookup and category ids.  Only the JSON index is implemented —
no masks, no evaluation — which is all SiamMOT uses.
"""

from __future__ import annotations

import json
from collections import defaultdict


class CocoDataset:
    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            d = json.load(f)
        self.imgs = {img["id"]: img for img in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self._img_to_anns = defaultdict(list)
        for a in d.get("annotations", []):
            self._img_to_anns[a["image_id"]].append(a)

    def get_img_ids(self) -> list:
        return sorted(self.imgs)

    def load_imgs(self, ids) -> list:
        return [self.imgs[i] for i in ids]

    def get_cat_ids(self) -> list:
        return sorted(self.cats)

    def load_cats(self, ids) -> list:
        return [self.cats[i] for i in ids]

    def anns_for_img(self, img_id) -> list:
        return self._img_to_anns.get(img_id, [])
