"""PandaSet dataset adapter: pickled DataFrames, pose JSON, world<->ego.

Capability parity with pcdet/datasets/pandaset/pandaset_dataset.py
(SURVEY.md §2.2 row 19). The reference needs the `pandaset` SDK only for
pose loading and two rigid-transform helpers; both are reimplemented here
(poses.json is plain JSON; `lidar_points_to_ego` is the inverse of the
pose's quaternion+translation). Runtime layout:

  root/dataset/<seq>/lidar/<frame>.pkl.gz     DataFrame x y z i t d
  root/dataset/<seq>/lidar/poses.json         [{position:{x,y,z},
                                               heading:{w,x,y,z}}, ...]
  root/dataset/<seq>/annotations/cuboids/<frame>.pkl.gz
      DataFrame position.* dimensions.* yaw label cuboids.sensor_id

Coordinate story (pandaset_dataset.py:150-256): world -> pandaset-ego via
the inverse pose, then pandaset-ego (x right, y fwd) -> normative lidar
(x fwd, y left) by the [1, 0, 2] axis swap + y negation; box yaw gains
`zrot_world_to_ego` (the ego y-axis bearing); intensity normalized /255.
Predictions are carried back with `predictions_to_world` mirroring
generate_prediction_dicts:258-325.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .processor import mask_points_outside_range


def _quat_to_matrix(w: float, x: float, y: float, z: float) -> np.ndarray:
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _pose_mat(pose: dict) -> np.ndarray:
    """(R, t) of the ego pose (pandaset SDK _heading_position_to_mat)."""
    h, p = pose["heading"], pose["position"]
    m = np.eye(4)
    m[:3, :3] = _quat_to_matrix(h["w"], h["x"], h["y"], h["z"])
    m[:3, 3] = [p["x"], p["y"], p["z"]]
    return m


def lidar_points_to_ego(points: np.ndarray, pose: dict) -> np.ndarray:
    """World -> pandaset-ego (ps.geometry.lidar_points_to_ego)."""
    m = _pose_mat(pose)
    return (points - m[:3, 3]) @ m[:3, :3]


def ego_to_lidar_points(points: np.ndarray, pose: dict) -> np.ndarray:
    """Pandaset-ego -> world (ps.geometry.ego_to_lidar_points)."""
    m = _pose_mat(pose)
    return points @ m[:3, :3].T + m[:3, 3]


class PandasetDataset:
    def __init__(self, root: str, infos: Optional[List[dict]] = None,
                 sequences: Optional[Sequence[str]] = None,
                 class_names: Sequence[str] = ("Car", "Pedestrian"),
                 training_categories: Optional[Dict[str, str]] = None,
                 lidar_device: int = 0,
                 point_cloud_range: Sequence[float] = (
                     -70.0, -40.0, -3.0, 70.0, 40.0, 1.0)):
        self.root = root
        self.class_names = tuple(class_names)
        self.training_categories = training_categories or {}
        self.lidar_device = lidar_device
        self.range = np.asarray(point_cloud_range, np.float32)
        self._poses: Dict[str, List[dict]] = {}
        if infos is not None:
            self.infos = list(infos)
        else:
            self.infos = self.get_infos(sequences)

    def get_infos(self, sequences: Optional[Sequence[str]] = None
                  ) -> List[dict]:
        """Enumerate (sequence, frame) pairs (get_infos:358-385)."""
        data_dir = os.path.join(self.root, "dataset")
        if sequences is None:
            sequences = (sorted(os.listdir(data_dir))
                         if os.path.isdir(data_dir) else [])
        infos = []
        for seq in sequences:
            lidar_dir = os.path.join(data_dir, seq, "lidar")
            if not os.path.isdir(lidar_dir):
                continue
            frames = sorted(f for f in os.listdir(lidar_dir)
                            if f.endswith(".pkl.gz") or f.endswith(".pkl"))
            for f in frames:
                ii = int(f.split(".")[0])
                infos.append({
                    "sequence": seq, "frame_idx": ii,
                    "lidar_path": os.path.join(lidar_dir, f),
                    "cuboids_path": os.path.join(
                        data_dir, seq, "annotations", "cuboids", f)})
        return infos

    def __len__(self) -> int:
        return len(self.infos)

    def pose(self, seq: str, frame_idx: int) -> dict:
        if seq not in self._poses:
            with open(os.path.join(self.root, "dataset", seq, "lidar",
                                   "poses.json")) as f:
                self._poses[seq] = json.load(f)
        return self._poses[seq][frame_idx]

    @staticmethod
    def _zrot_world_to_ego(pose: dict) -> float:
        """Bearing of the ego +y axis (pandaset_dataset.py:222-231)."""
        pts = lidar_points_to_ego(np.array([[0, 0, 0], [0, 1.0, 0]]), pose)
        yaxis = pts[1] - pts[0]
        return float(np.arctan2(-yaxis[0], yaxis[1]))

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        import pandas as pd

        info = self.infos[idx]
        pose = self.pose(info["sequence"], info["frame_idx"])

        df = pd.read_pickle(info["lidar_path"])
        if self.lidar_device != -1 and "d" in df:
            df = df[df.d == self.lidar_device]
        world = df.to_numpy()
        ego = lidar_points_to_ego(world[:, :3], pose)
        pts = np.empty((len(ego), 4), np.float32)
        pts[:, 0] = ego[:, 1]                  # ego -> normative
        pts[:, 1] = -ego[:, 0]
        pts[:, 2] = ego[:, 2]
        pts[:, 3] = world[:, 3] / 255.0        # intensity to [0, 1]

        boxes = np.zeros((0, 7), np.float32)
        names: List[str] = []
        if os.path.exists(info["cuboids_path"]):
            cub = pd.read_pickle(info["cuboids_path"])
            if self.lidar_device != -1 and "cuboids.sensor_id" in cub:
                cub = cub[cub["cuboids.sensor_id"] != 1 - self.lidar_device]
            centers = np.stack([cub["position.x"].to_numpy(),
                                cub["position.y"].to_numpy(),
                                cub["position.z"].to_numpy()], axis=1)
            ego_c = lidar_points_to_ego(centers, pose)
            zrot = self._zrot_world_to_ego(pose)
            raw_names = [self.training_categories.get(str(n), str(n))
                         for n in cub["label"].to_numpy()]
            boxes = np.stack([
                ego_c[:, 1], -ego_c[:, 0], ego_c[:, 2],
                cub["dimensions.y"].to_numpy(),
                cub["dimensions.x"].to_numpy(),
                cub["dimensions.z"].to_numpy(),
                cub["yaw"].to_numpy() + zrot], axis=1).astype(np.float32)
            names = raw_names

        sel = [i for i, n in enumerate(names) if n in self.class_names]
        pts = mask_points_outside_range(pts, self.range)
        return {"frame_id": f"{info['sequence']}/{info['frame_idx']:02d}",
                "sequence": info["sequence"],
                "frame_idx": info["frame_idx"],
                "points": pts,
                "gt_boxes": boxes[sel] if len(sel)
                else np.zeros((0, 7), np.float32),
                "gt_classes": np.asarray(
                    [self.class_names.index(names[i]) + 1 for i in sel],
                    np.int32),
                "gt_names": [names[i] for i in sel],
                "zrot_world_to_ego": self._zrot_world_to_ego(pose),
                "pose": pose}

    def det_batch(self, indices: Sequence[int], voxel_size, max_voxels: int,
                  max_points_per_voxel: int = 5, max_points: int = 16384,
                  max_gt: int = 50, rulebook_caps=None):
        from .detbatch import assemble_det_batch
        return assemble_det_batch(
            self, indices, voxel_size, max_voxels,
            max_points_per_voxel=max_points_per_voxel,
            max_points=max_points, max_gt=max_gt,
            rulebook_caps=rulebook_caps, num_features=4)

    def predictions_to_world(self, boxes: np.ndarray, names: Sequence[str],
                             scores: np.ndarray, pose: dict,
                             zrot_world_to_ego: float) -> Dict:
        """Normative lidar boxes -> pandaset world cuboid records
        (generate_prediction_dicts:272-322)."""
        ego = np.stack([-boxes[:, 1], boxes[:, 0], boxes[:, 2]], axis=1)
        world = ego_to_lidar_points(ego, pose)
        return {"position.x": world[:, 0], "position.y": world[:, 1],
                "position.z": world[:, 2],
                "dimensions.x": boxes[:, 4], "dimensions.y": boxes[:, 3],
                "dimensions.z": boxes[:, 5],
                "yaw": (boxes[:, 6] - zrot_world_to_ego) % (2 * np.pi),
                "label": list(names), "score": np.asarray(scores)}
