"""Synthetic mini-JRDB fixture: writes a tiny on-disk dataset in JRDB layout.

SURVEY.md §4(c): random-but-valid jpgs / binary pcds / annotation npy for
end-to-end pipeline + train-step tests without the real (absent) dataset.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def write_synthetic_jrdb(root: str, num_seqs: int = 2, frames_per_seq: int = 4,
                         people_per_frame: int = 5, image_hw=(120, 200),
                         seed: int = 0, points_per_scan: int = 300,
                         point_range: float = 5.0) -> None:
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "train_dataset_with_activity")
    img_root = os.path.join(base, "images", "image_stitched")
    pc_lower = os.path.join(base, "pointclouds", "lower_velodyne")
    pc_upper = os.path.join(base, "pointclouds", "upper_velodyne")
    lbl_root = os.path.join(base, "labels_2019")
    for d in (img_root, pc_lower, pc_upper, lbl_root):
        os.makedirs(d, exist_ok=True)

    from PIL import Image

    h, w = image_hw
    anns = {}
    for s in range(num_seqs):
        seq = f"seq_{s:02d}"
        os.makedirs(os.path.join(img_root, seq), exist_ok=True)
        os.makedirs(os.path.join(pc_lower, seq), exist_ok=True)
        os.makedirs(os.path.join(pc_upper, seq), exist_ok=True)
        anns[s] = {}
        for f in range(frames_per_seq):
            img = (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(img_root, seq, f"{f:06d}.jpg"))
            for pc_dir in (pc_lower, pc_upper):
                r = point_range
                pts = rng.uniform([-r, -r, -1, 0], [r, r, 2, 1],
                                  (points_per_scan, 4)).astype(np.float32)
                _write_pcd(os.path.join(pc_dir, seq, f"{f:06d}.pcd"), pts)

            npers = people_per_frame
            frame_ann = {
                "bboxes_2d": [], "bboxes_3d": [], "actions": [],
                "person_id": [], "social_group_id": [],
                "social_group_activity": [],
            }
            for p in range(npers):
                x, y = rng.uniform(0.05, 0.7, 2)
                bw, bh = rng.uniform(0.05, 0.2, 2)
                frame_ann["bboxes_2d"].append((x, y, bw, bh))
                frame_ann["bboxes_3d"].append({
                    "cx": float(rng.uniform(-4, 4)),
                    "cy": float(rng.uniform(-4, 4)),
                    "cz": float(rng.uniform(-0.5, 0.5)),
                    "l": 0.8, "w": 0.8, "h": 1.7,
                    "rot_z": float(rng.uniform(-np.pi, np.pi))})
                act = [0] * 27
                act[int(rng.integers(0, 27))] = 1
                frame_ann["actions"].append(act)
                sg_act = [0] * 27
                sg_act[int(rng.integers(0, 27))] = 1
                frame_ann["social_group_activity"].append(sg_act)
                frame_ann["person_id"].append(p)
                frame_ann["social_group_id"].append(int(rng.integers(0, 3)))
            anns[s][f] = frame_ann

    for split in ("train", "test"):
        np.save(os.path.join(lbl_root, f"{split}_annotations.npy"),
                anns, allow_pickle=True)


def _write_pcd(path: str, pts: np.ndarray) -> None:
    """Write a binary PCD with x y z intensity float32 fields."""
    n = len(pts)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(pts, np.float32).tobytes())
