"""KITTI dataset adapter: calibration, labels, velodyne IO, detection batches.

Capability parity with the reference's vendored per-dataset adapters
(SURVEY.md §2.2 row 19): pcdet/datasets/kitti/kitti_dataset.py:1-484 and
pcdet/utils/{calibration_kitti,object3d_kitti}.py — re-implemented from the
public KITTI format spec (this module parses the standard files directly;
nothing is ported from the reference's info-pkl pipeline):

  - calib txt: P0..P3 (3x4), R0_rect (3x3), Tr_velo_to_cam (3x4)
  - label txt: type, truncated, occluded, alpha, bbox(4), dims h w l,
    location x y z (camera frame, bottom center), rotation_y
  - velodyne .bin: float32 (N, 4) x y z intensity

Camera-frame GT boxes convert to the lidar frame (cx cy cz dx dy dz heading)
with dx=l, dy=w, dz=h, z raised by h/2 to the box center and
heading = -(ry + pi/2), matching box_utils.boxes3d_kitti_camera_to_lidar.

The batch assembly path voxelizes with data/voxelizer.py and pads to the
fixed shapes DetBatch expects, so every detector in detection/ can train on
KITTI data unchanged.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .processor import mask_points_outside_range

KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")
_DIFFICULTY = {"easy": 0, "moderate": 1, "hard": 2}


@dataclasses.dataclass
class KittiCalib:
    P2: np.ndarray            # (3, 4)
    R0: np.ndarray            # (3, 3)
    V2C: np.ndarray           # (3, 4) velodyne -> camera

    @property
    def lidar_to_cam(self) -> np.ndarray:
        """(4, 4) rectified-camera-frame transform."""
        v2c = np.vstack([self.V2C, [0, 0, 0, 1]]).astype(np.float32)
        r0 = np.eye(4, dtype=np.float32)
        r0[:3, :3] = self.R0
        return r0 @ v2c

    def lidar_to_img(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N, 3) lidar points -> ((N, 2) pixels, (N,) depths)."""
        hom = np.hstack([pts, np.ones((pts.shape[0], 1), pts.dtype)])
        cam = (self.lidar_to_cam @ hom.T).T
        img = (self.P2 @ np.hstack(
            [cam[:, :3], np.ones((len(cam), 1), cam.dtype)]).T).T
        depth = img[:, 2]
        return img[:, :2] / np.maximum(depth[:, None], 1e-6), depth

    def rect_to_lidar(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) rectified-camera points -> lidar frame."""
        inv = np.linalg.inv(self.lidar_to_cam)
        hom = np.hstack([pts, np.ones((pts.shape[0], 1), pts.dtype)])
        return (inv @ hom.T).T[:, :3]


def parse_calib(path: str) -> KittiCalib:
    vals: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, rest = line.split(":", 1)
            arr = np.fromstring(rest, sep=" ", dtype=np.float32)
            vals[key.strip()] = arr
    return KittiCalib(
        P2=vals["P2"].reshape(3, 4),
        R0=vals["R0_rect"].reshape(3, 3),
        V2C=vals["Tr_velo_to_cam"].reshape(3, 4))


@dataclasses.dataclass
class KittiObject:
    cls_type: str
    truncation: float
    occlusion: float
    alpha: float
    box2d: np.ndarray         # (4,) x1 y1 x2 y2
    h: float
    w: float
    l: float                  # noqa: E741 — KITTI's own field name
    loc: np.ndarray           # (3,) camera frame, bottom center
    ry: float

    @property
    def difficulty(self) -> int:
        """official KITTI difficulty (object3d_kitti.get_kitti_obj_level)."""
        height = self.box2d[3] - self.box2d[1]
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 2
        return -1


def parse_label(path: str) -> List[KittiObject]:
    objs = []
    with open(path) as f:
        for line in f:
            p = line.strip().split(" ")
            if len(p) < 15:
                continue
            objs.append(KittiObject(
                cls_type=p[0], truncation=float(p[1]), occlusion=float(p[2]),
                alpha=float(p[3]),
                box2d=np.asarray(p[4:8], np.float32),
                h=float(p[8]), w=float(p[9]), l=float(p[10]),
                loc=np.asarray(p[11:14], np.float32), ry=float(p[14])))
    return objs


def load_velodyne(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def boxes_camera_to_lidar(objs: Sequence[KittiObject],
                          calib: KittiCalib) -> np.ndarray:
    """-> (N, 7) lidar boxes (box_utils.boxes3d_kitti_camera_to_lidar)."""
    if not objs:
        return np.zeros((0, 7), np.float32)
    loc = np.stack([o.loc for o in objs])
    dims = np.asarray([[o.l, o.w, o.h] for o in objs], np.float32)
    ry = np.asarray([o.ry for o in objs], np.float32)
    xyz = calib.rect_to_lidar(loc)
    xyz[:, 2] += dims[:, 2] / 2                     # bottom -> center
    heading = -(ry + np.pi / 2)
    return np.hstack([xyz, dims, heading[:, None]]).astype(np.float32)


class KittiDataset:
    """Minimal-but-complete KITTI object adapter.

    Layout: root/{training,testing}/{velodyne,label_2,calib}/<frame>.{bin,txt}
    plus optional ImageSets/<split>.txt index files.
    """

    def __init__(self, root: str, split: str = "train",
                 class_names: Sequence[str] = KITTI_CLASSES,
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4,
                                                       40, 1)):
        self.root = root
        self.split = split
        self.class_names = tuple(class_names)
        self.range = np.asarray(point_cloud_range, np.float32)
        sub = "testing" if split == "test" else "training"
        self.base = os.path.join(root, sub)
        ids_file = os.path.join(root, "ImageSets", f"{split}.txt")
        if os.path.exists(ids_file):
            with open(ids_file) as f:
                self.ids = [x.strip() for x in f if x.strip()]
        else:
            vel = os.path.join(self.base, "velodyne")
            self.ids = sorted(os.path.splitext(x)[0]
                              for x in os.listdir(vel)) \
                if os.path.isdir(vel) else []

    def __len__(self) -> int:
        return len(self.ids)

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        fid = self.ids[idx]
        pts = load_velodyne(os.path.join(self.base, "velodyne",
                                         f"{fid}.bin"))
        calib = parse_calib(os.path.join(self.base, "calib", f"{fid}.txt"))
        label_path = os.path.join(self.base, "label_2", f"{fid}.txt")
        objs = parse_label(label_path) if os.path.exists(label_path) else []
        keep = [o for o in objs if o.cls_type in self.class_names]
        boxes = boxes_camera_to_lidar(keep, calib)
        classes = np.asarray(
            [self.class_names.index(o.cls_type) + 1 for o in keep],
            np.int32)
        # range mask (x/y only — pcdet mask_points_by_range ignores z)
        pts = mask_points_outside_range(pts, self.range)
        return {"frame_id": fid, "points": pts, "gt_boxes": boxes,
                "gt_classes": classes, "calib": calib,
                "difficulty": np.asarray([o.difficulty for o in keep],
                                         np.int32)}

    def det_batch(self, indices: Sequence[int], voxel_size, max_voxels: int,
                  max_points_per_voxel: int = 5, max_points: int = 16384,
                  max_gt: int = 50, rulebook_caps=None):
        """Assemble a fixed-shape DetBatch (detection/detectors.py) from
        raw frames: voxelize, pad, build the sparse-conv rulebook."""
        from .detbatch import assemble_det_batch
        return assemble_det_batch(
            self, indices, voxel_size, max_voxels,
            max_points_per_voxel=max_points_per_voxel,
            max_points=max_points, max_gt=max_gt,
            rulebook_caps=rulebook_caps, num_features=4)
