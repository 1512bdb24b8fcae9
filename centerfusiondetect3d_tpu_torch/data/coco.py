"""Minimal COCO-format annotation reader.

The port's own copy of ``centerfusiondetect3d_tpu/data/coco.py``
(numpy only), unchanged but for this paragraph.

Self-contained replacement for pycocotools' COCO class (not a dependency)
covering exactly what the converter output needs
(reference src/convert_nuScenes.py:126-359 schema:
images/annotations/categories/videos/attributes). Index-building only; no C
extension required.
"""

from __future__ import annotations

import json
from typing import Dict, List


class CocoReader:
    def __init__(self, ann_path: str):
        with open(ann_path) as f:
            self.dataset = json.load(f)
        self.imgs: Dict[int, dict] = {img["id"]: img for img in self.dataset.get("images", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self.img_to_anns: Dict[int, List[int]] = {i: [] for i in self.imgs}
        for a in self.dataset.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a["id"])
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_imgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def get_ann_ids(self, img_ids) -> List[int]:
        if isinstance(img_ids, int):
            img_ids = [img_ids]
        out: List[int] = []
        for i in img_ids:
            out.extend(self.img_to_anns.get(i, []))
        return out

    def load_anns(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]
