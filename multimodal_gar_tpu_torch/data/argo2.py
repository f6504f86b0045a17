"""Argoverse 2 dataset adapter: KITTI-style infos + .bin lidar + CDS eval.

Capability parity with pcdet/datasets/argo2/argo2_dataset.py (SURVEY.md
§2.2 row 19). The reference's runtime path is SDK-free — info pickles
whose `annos` carry lidar-frame location/dimensions/rotation_y directly
(argo2_dataset.py:163-171; no camera conversion) plus float32 (N, 4)
velodyne .bin files — and the av2 SDK appears only in the official eval
and feather formatting, which eval/argo2_eval.py and
`boxes_to_argo2`/`argo2_to_boxes` replace.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Dict, List, Sequence

import numpy as np

from .processor import mask_points_outside_range

from ..eval.argo2_eval import COMPETITION_CATEGORIES, Argo2Frame

# feather column order (argo2_utils/constants.py LABEL_ATTR)
LABEL_ATTR = ("tx_m", "ty_m", "tz_m", "length_m", "width_m", "height_m",
              "qw", "qx", "qy", "qz")


def boxes_to_argo2(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) lidar boxes -> (N, 10) argo2 cuboid rows
    (argo2_dataset.lidar_box_to_argo2:251-268: lwh column order and the
    yaw -> -yaw - pi/2 frame change, wrapped to [-pi, pi], as a
    z-rotation quaternion)."""
    boxes = np.asarray(boxes, np.float64)
    lwh = boxes[:, [4, 3, 5]]
    yaw = -boxes[:, 6] - 0.5 * np.pi
    yaw = (yaw + np.pi) % (2 * np.pi) - np.pi
    quat = np.stack([np.cos(yaw / 2), np.zeros_like(yaw),
                     np.zeros_like(yaw), np.sin(yaw / 2)], axis=1)
    return np.concatenate([boxes[:, :3], lwh, quat], axis=1)


def argo2_to_boxes(rows: np.ndarray) -> np.ndarray:
    """(N, 10) argo2 cuboid rows -> (N, 7) lidar boxes (inverse of
    boxes_to_argo2; quaternion assumed a z-rotation)."""
    rows = np.asarray(rows, np.float64)
    yaw_argo = 2 * np.arctan2(rows[:, 9], rows[:, 6])
    yaw = -yaw_argo - 0.5 * np.pi
    yaw = (yaw + np.pi) % (2 * np.pi) - np.pi
    dims = rows[:, [4, 3, 5]]                 # length width -> dx dy
    return np.concatenate([rows[:, :3], dims, yaw[:, None]],
                          axis=1).astype(np.float32)


class Argo2Dataset:
    def __init__(self, root: str, info_paths: Sequence[str],
                 class_names: Sequence[str] = COMPETITION_CATEGORIES,
                 split: str = "train",
                 point_cloud_range: Sequence[float] = (
                     -75.2, -75.2, -2.0, 75.2, 75.2, 4.0)):
        self.root = root
        self.class_names = tuple(class_names)
        self.range = np.asarray(point_cloud_range, np.float32)
        self.base = os.path.join(
            root, "testing" if split == "test" else "training")
        self.infos: List[dict] = []
        for p in info_paths:
            path = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    self.infos.extend(pickle.load(f))

    def __len__(self) -> int:
        return len(self.infos)

    def get_lidar(self, sample_idx: str) -> np.ndarray:
        path = os.path.join(self.base, "velodyne", f"{sample_idx}.bin")
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        sample_idx = os.path.splitext(os.path.basename(
            info["point_cloud"]["velodyne_path"]))[0]
        pts = self.get_lidar(sample_idx)
        pts = mask_points_outside_range(pts, self.range)
        out: Dict = {"frame_id": sample_idx,
                     "uuid": info.get("uuid", sample_idx),
                     "points": pts}
        annos = info.get("annos")
        if annos is not None:
            boxes = np.concatenate(
                [np.asarray(annos["location"], np.float32),
                 np.asarray(annos["dimensions"], np.float32),
                 np.asarray(annos["rotation_y"],
                            np.float32)[:, None]], axis=1)
            names = [str(n) for n in annos["name"]]
            sel = [i for i, n in enumerate(names) if n in self.class_names]
            out["gt_boxes"] = boxes[sel]
            out["gt_names"] = [names[i] for i in sel]
            out["gt_classes"] = np.asarray(
                [self.class_names.index(names[i]) + 1 for i in sel],
                np.int32)
            if "num_points_in_gt" in annos:
                out["num_points_in_gt"] = np.asarray(
                    annos["num_points_in_gt"])[sel]
        else:
            out["gt_boxes"] = np.zeros((0, 7), np.float32)
            out["gt_names"] = []
            out["gt_classes"] = np.zeros((0,), np.int32)
        return out

    def det_batch(self, indices: Sequence[int], voxel_size, max_voxels: int,
                  max_points_per_voxel: int = 5, max_points: int = 16384,
                  max_gt: int = 50, rulebook_caps=None):
        from .detbatch import assemble_det_batch
        return assemble_det_batch(
            self, indices, voxel_size, max_voxels,
            max_points_per_voxel=max_points_per_voxel,
            max_points=max_points, max_gt=max_gt,
            rulebook_caps=rulebook_caps, num_features=4)

    def evaluation(self, det_annos: Sequence[dict],
                   max_range_m: float = 150.0,
                   indices: Optional[Sequence[int]] = None) -> Dict:
        """CDS evaluation over `det_annos` [{name, boxes_lidar, score}]
        aligned with self.infos (argo2_dataset.evaluation:269-330 without
        the av2 dependency)."""
        from ..eval.argo2_eval import evaluate
        # positional alignment guard — see WaymoDataset.evaluation
        infos = (self.infos if indices is None
                 else [self.infos[i] for i in indices])
        if len(det_annos) != len(infos):
            raise ValueError(
                f"{len(det_annos)} det_annos vs {len(infos)} frames; pass "
                "indices= to align a subset")
        frames = []
        for det, info in zip(det_annos, infos):
            annos = info.get("annos", {})
            boxes = np.concatenate(
                [np.asarray(annos.get("location", np.zeros((0, 3))),
                            np.float32).reshape(-1, 3),
                 np.asarray(annos.get("dimensions", np.zeros((0, 3))),
                            np.float32).reshape(-1, 3),
                 np.asarray(annos.get("rotation_y", np.zeros(0)),
                            np.float32).reshape(-1, 1)], axis=1)
            names = [str(n) for n in annos.get("name", [])]
            npts = np.asarray(annos.get("num_points_in_gt",
                                        np.full(len(names), -1)))
            frames.append(Argo2Frame(
                gt_boxes=boxes, gt_names=names,
                det_boxes=np.asarray(det["boxes_lidar"],
                                     np.float32)[:, :7],
                det_names=[str(n) for n in det["name"]],
                det_scores=np.asarray(det["score"], np.float32),
                gt_num_interior_pts=npts))
        return evaluate(frames, categories=self.class_names,
                        max_range_m=max_range_m)
