"""Custom-dataset adapter: plain npy points + txt labels.

Capability parity with pcdet/datasets/custom/custom_dataset.py (SURVEY.md
§2.2 row 19): the SDK-free adapter format —
  root/points/<id>.npy          (N, 4) x y z intensity
  root/labels/<id>.txt          per line: x y z dx dy dz heading category
  root/ImageSets/<split>.txt    frame ids
with optional class mapping to KITTI names for evaluation
(MAP_CLASS_TO_KITTI). No info-pkl caching layer: frames parse directly.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .processor import mask_points_outside_range


class CustomDataset:
    def __init__(self, root: str, split: str = "train",
                 class_names: Sequence[str] = ("Vehicle",),
                 point_cloud_range: Sequence[float] = (-70, -40, -3, 70,
                                                       40, 1),
                 map_class_to_kitti: Optional[Dict[str, str]] = None):
        self.root = root
        self.class_names = tuple(class_names)
        self.range = np.asarray(point_cloud_range, np.float32)
        self.map_class_to_kitti = map_class_to_kitti or {}
        ids_file = os.path.join(root, "ImageSets", f"{split}.txt")
        if os.path.exists(ids_file):
            with open(ids_file) as f:
                self.ids = [x.strip() for x in f if x.strip()]
        else:
            pdir = os.path.join(root, "points")
            self.ids = sorted(os.path.splitext(x)[0]
                              for x in os.listdir(pdir)) \
                if os.path.isdir(pdir) else []

    def __len__(self) -> int:
        return len(self.ids)

    def get_label(self, frame_id: str) -> Tuple[np.ndarray, List[str]]:
        """(N, 7) boxes + names (custom_dataset.get_label:51-71)."""
        path = os.path.join(self.root, "labels", f"{frame_id}.txt")
        boxes, names = [], []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    p = line.strip().split(" ")
                    if len(p) < 8:
                        continue
                    boxes.append([float(x) for x in p[:7]])
                    names.append(p[7])
        return (np.asarray(boxes, np.float32).reshape(-1, 7), names)

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        fid = self.ids[idx]
        pts = np.load(os.path.join(self.root, "points", f"{fid}.npy"))
        boxes, names = self.get_label(fid)
        keep = [i for i, n in enumerate(names) if n in self.class_names]
        classes = np.asarray([self.class_names.index(names[i]) + 1
                              for i in keep], np.int32)
        pts = mask_points_outside_range(pts, self.range)
        return {"frame_id": fid, "points": pts.astype(np.float32),
                "gt_boxes": boxes[keep], "gt_classes": classes,
                "gt_names": [names[i] for i in keep]}

    def kitti_name(self, name: str) -> str:
        return self.map_class_to_kitti.get(name, name)
