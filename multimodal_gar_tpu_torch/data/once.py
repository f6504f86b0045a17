"""ONCE dataset adapter: sequence folders + per-sequence JSON annotations.

Capability parity with pcdet/datasets/once/{once_dataset,once_toolkits}.py
(SURVEY.md §2.2 row 19) — ONCE ships no external SDK; its vendored toolkit
reads a plain layout which this module parses directly:

  root/data/<seq_id>/<seq_id>.json     {"calib": {...}, "frames": [
      {"frame_id", "pose", "annos": {"names": [...],
       "boxes_3d": [[cx cy cz l w h yaw], ...], "boxes_2d": {...}}}]}
  root/data/<seq_id>/lidar_roof/<frame_id>.bin   float32 (N, 4)
  root/ImageSets/<split>.txt                     sequence ids
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .processor import mask_points_outside_range

ONCE_CLASSES = ("Car", "Bus", "Truck", "Pedestrian", "Cyclist")
SUPERCLASS = {"Car": "Vehicle", "Bus": "Vehicle", "Truck": "Vehicle"}


class OnceDataset:
    def __init__(self, root: str, split: str = "train",
                 class_names: Sequence[str] = ONCE_CLASSES,
                 point_cloud_range: Sequence[float] = (-75.2, -75.2, -5.0,
                                                       75.2, 75.2, 3.0)):
        self.root = root
        self.class_names = tuple(class_names)
        self.range = np.asarray(point_cloud_range, np.float32)
        ids_file = os.path.join(root, "ImageSets", f"{split}.txt")
        if os.path.exists(ids_file):
            with open(ids_file) as f:
                seqs = [x.strip() for x in f if x.strip()]
        else:
            data = os.path.join(root, "data")
            seqs = sorted(os.listdir(data)) if os.path.isdir(data) else []
        self.frames: List[Tuple[str, str, dict]] = []
        self.calib: Dict[str, dict] = {}
        for seq in seqs:
            anno_path = os.path.join(root, "data", seq, f"{seq}.json")
            if not os.path.exists(anno_path):
                continue
            with open(anno_path) as f:
                seq_anno = json.load(f)
            self.calib[seq] = seq_anno.get("calib", {})
            for fr in seq_anno.get("frames", []):
                self.frames.append((seq, fr["frame_id"], fr))

    def __len__(self) -> int:
        return len(self.frames)

    def load_point_cloud(self, seq: str, frame_id: str) -> np.ndarray:
        """(N, 4) roof-lidar points (once_toolkits.load_point_cloud)."""
        path = os.path.join(self.root, "data", seq, "lidar_roof",
                            f"{frame_id}.bin")
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        seq, fid, info = self.frames[idx]
        pts = self.load_point_cloud(seq, fid)
        annos = info.get("annos", {})
        names = annos.get("names", [])
        boxes = np.asarray(annos.get("boxes_3d", []),
                           np.float32).reshape(-1, 7)
        keep = [i for i, n in enumerate(names) if n in self.class_names]
        classes = np.asarray([self.class_names.index(names[i]) + 1
                              for i in keep], np.int32)
        pts = mask_points_outside_range(pts, self.range)
        return {"frame_id": f"{seq}/{fid}", "points": pts,
                "gt_boxes": boxes[keep], "gt_classes": classes,
                "gt_names": [names[i] for i in keep],
                "pose": np.asarray(info.get("pose", []), np.float32)}
