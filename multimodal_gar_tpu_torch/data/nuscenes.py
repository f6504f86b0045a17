"""nuScenes dataset adapter: info pickles, multi-sweep lidar, NDS plumbing.

Capability parity with pcdet/datasets/nuscenes/{nuscenes_dataset,
nuscenes_utils}.py (SURVEY.md §2.2 row 19). The runtime path there needs no
SDK — it reads pre-built info pickles plus raw `.bin` lidar files
(nuscenes_dataset.py:76-151) — so this module implements that path
directly, along with the detection→submission transform the reference
delegates to the devkit (nuscenes_utils.py:383-468):

  - info pickles: list of dicts with lidar_path, token, sweeps
    [{lidar_path, transform_matrix, time_lag}], ref_from_car,
    car_from_global, gt_boxes (N, 9: cx cy cz dx dy dz yaw vx vy),
    gt_names, num_lidar_pts;
  - class-balanced resampling (nuscenes_dataset.py:39-74, CBGS);
  - multi-sweep aggregation with ego-point removal and a time-lag feature
    channel (nuscenes_dataset.py:76-109);
  - lidar→global box transform + attribute assignment for submission
    (nuscenes_utils.py:423-468), feeding eval/nuscenes_eval.py.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .processor import mask_points_outside_range

from ..eval.nuscenes_eval import Frames, NuscBox

NUSCENES_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone")

# General (annotation) category -> detection class
# (nuscenes_utils.map_name_from_general_to_detection:16-40).
MAP_GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

# Most-frequent attribute per class (argmax of nuscenes_utils.cls_attr_dist
# :43-154) — the fallback the reference uses when motion rules don't apply.
DEFAULT_ATTRIBUTE = {
    "barrier": "cycle.with_rider",        # all-zero dist -> first key
    "bicycle": "cycle.without_rider",
    "bus": "vehicle.moving",
    "car": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "motorcycle": "cycle.without_rider",
    "pedestrian": "pedestrian.moving",
    "traffic_cone": "cycle.with_rider",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
}


def _quat_from_matrix(r: np.ndarray) -> np.ndarray:
    """(3, 3) rotation matrix -> unit quaternion (w, x, y, z)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k]) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def quaternion_yaw(q: np.ndarray) -> float:
    """Yaw of the quaternion-rotated x-axis (nuscenes_utils.py:234-249)."""
    w, x, y, z = q
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + w * z)
    return float(np.arctan2(vy, vx))


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


class NuScenesDataset:
    """Info-pickle-driven nuScenes adapter (no SDK required at runtime)."""

    def __init__(self, root: str, info_paths: Sequence[str],
                 class_names: Sequence[str] = NUSCENES_CLASSES,
                 max_sweeps: int = 1,
                 balanced_resampling: bool = False,
                 filter_min_points_in_gt: int = 0,
                 pred_velocity: bool = False,
                 point_cloud_range: Sequence[float] = (
                     -51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 seed: int = 0):
        self.root = root
        self.class_names = tuple(class_names)
        self.max_sweeps = max_sweeps
        self.filter_min_points_in_gt = filter_min_points_in_gt
        self.pred_velocity = pred_velocity
        self.range = np.asarray(point_cloud_range, np.float32)
        self.rng = np.random.default_rng(seed)
        self.infos: List[dict] = []
        for p in info_paths:
            path = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if balanced_resampling:
            self.infos = self.balanced_infos_resampling(self.infos)

    def balanced_infos_resampling(self, infos: List[dict]) -> List[dict]:
        """CBGS class-balanced duplication (nuscenes_dataset.py:39-74)."""
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info.get("gt_names", ())):
                if name in cls_infos:
                    cls_infos[name].append(info)
        total = sum(len(v) for v in cls_infos.values())
        if total == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled: List[dict] = []
        for v in cls_infos.values():
            if not v:
                continue
            ratio = frac / (len(v) / total)
            idx = self.rng.choice(len(v), int(len(v) * ratio))
            sampled.extend(v[i] for i in idx)
        return sampled

    def __len__(self) -> int:
        return len(self.infos)

    def _read_bin(self, rel_path: str) -> np.ndarray:
        path = os.path.join(self.root, rel_path)
        return np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :4]

    def get_sweep(self, sweep: dict):
        """One past sweep -> (points (N, 4), time lag (N, 1))
        (nuscenes_dataset.py:76-90: ego-radius removal + ref transform)."""
        pts = self._read_bin(sweep["lidar_path"])
        mask = ~((np.abs(pts[:, 0]) < 1.0) & (np.abs(pts[:, 1]) < 1.0))
        pts = pts[mask]
        tm = sweep.get("transform_matrix")
        if tm is not None:
            hom = np.hstack([pts[:, :3], np.ones((len(pts), 1), pts.dtype)])
            pts[:, :3] = (np.asarray(tm, np.float64) @ hom.T).T[:, :3]
        times = np.full((len(pts), 1), float(sweep["time_lag"]), pts.dtype)
        return pts, times

    def get_lidar_with_sweeps(self, index: int) -> np.ndarray:
        """(N, 5) x y z intensity time (nuscenes_dataset.py:92-109)."""
        info = self.infos[index]
        points = self._read_bin(info["lidar_path"])
        pts_list = [points]
        times_list = [np.zeros((len(points), 1), points.dtype)]
        sweeps = info.get("sweeps", [])
        n_extra = min(self.max_sweeps - 1, len(sweeps))
        if n_extra > 0:
            for k in self.rng.choice(len(sweeps), n_extra, replace=False):
                p, t = self.get_sweep(sweeps[int(k)])
                pts_list.append(p)
                times_list.append(t)
        points = np.concatenate(pts_list, axis=0)
        times = np.concatenate(times_list, axis=0).astype(points.dtype)
        return np.concatenate([points, times], axis=1)

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        pts = self.get_lidar_with_sweeps(idx)
        pts = mask_points_outside_range(pts, self.range)
        boxes = np.asarray(info.get("gt_boxes",
                                    np.zeros((0, 9))), np.float32)
        names = list(info.get("gt_names", ()))
        if self.filter_min_points_in_gt > 0 and len(boxes):
            keep = (np.asarray(info["num_lidar_pts"])
                    >= self.filter_min_points_in_gt)
            boxes, names = boxes[keep], [n for n, k in zip(names, keep) if k]
        sel = [i for i, n in enumerate(names) if n in self.class_names]
        boxes = boxes[sel] if len(boxes) else boxes.reshape(-1, 9)
        boxes = np.nan_to_num(boxes)          # SET_NAN_VELOCITY_TO_ZEROS
        if not self.pred_velocity and boxes.shape[1] > 7:
            boxes = boxes[:, :7]
        classes = np.asarray([self.class_names.index(names[i]) + 1
                              for i in sel], np.int32)
        return {"frame_id": os.path.splitext(
                    os.path.basename(info["lidar_path"]))[0],
                "token": info.get("token", ""),
                "points": pts, "gt_boxes": boxes,
                "gt_classes": classes,
                "gt_names": [names[i] for i in sel]}

    def det_batch(self, indices: Sequence[int], voxel_size, max_voxels: int,
                  max_points_per_voxel: int = 5, max_points: int = 16384,
                  max_gt: int = 50, rulebook_caps=None):
        from .detbatch import assemble_det_batch
        return assemble_det_batch(
            self, indices, voxel_size, max_voxels,
            max_points_per_voxel=max_points_per_voxel,
            max_points=max_points, max_gt=max_gt,
            rulebook_caps=rulebook_caps, num_features=5)

    # ---- NDS evaluation plumbing -------------------------------------

    def _global_from_lidar(self, info: dict) -> np.ndarray:
        """(4, 4): inverse of ref_from_car @ car_from_global."""
        lidar_from_global = (np.asarray(info["ref_from_car"], np.float64)
                             @ np.asarray(info["car_from_global"],
                                          np.float64))
        return np.linalg.inv(lidar_from_global)

    def _boxes_to_nusc(self, boxes: np.ndarray, names: Sequence[str],
                       info: dict, scores: Optional[np.ndarray],
                       num_pts: Optional[np.ndarray]) -> List[NuscBox]:
        """Lidar-frame (N, 7|9) boxes -> global-frame NuscBox list
        (nuscenes_utils.boxes_lidar_to_nusenes + lidar_nusc_box_to_global)."""
        g = self._global_from_lidar(info)
        rot, trans = g[:3, :3], g[:3, 3]
        ego_global = np.linalg.inv(
            np.asarray(info["car_from_global"], np.float64))[:3, 3]
        out = []
        for k in range(len(boxes)):
            b = np.asarray(boxes[k], np.float64)
            center = rot @ b[:3] + trans
            yaw = quaternion_yaw(_quat_from_matrix(rot @ _yaw_matrix(b[6])))
            vel3 = rot @ np.array([b[7], b[8], 0.0]) \
                if len(b) >= 9 else np.zeros(3)
            name = names[k]
            speed = float(np.hypot(vel3[0], vel3[1]))
            if scores is not None:
                attr = self._attribute(name, speed)
            else:
                attr = ""
            out.append(NuscBox(
                translation=center,
                size=np.array([b[4], b[3], b[5]]),       # dx dy dz -> w l h
                yaw=yaw, name=name, velocity=vel3[:2],
                score=float(scores[k]) if scores is not None else -1.0,
                attribute=attr,
                ego_dist=float(np.linalg.norm(center[:2] - ego_global[:2])),
                num_pts=int(num_pts[k]) if num_pts is not None else -1))
        return out

    @staticmethod
    def _attribute(name: str, speed: float) -> str:
        """Motion-rule attribute assignment (nuscenes_utils.py:436-453)."""
        if speed > 0.2:
            if name in ("car", "construction_vehicle", "bus", "truck",
                        "trailer"):
                return "vehicle.moving"
            if name in ("bicycle", "motorcycle"):
                return "cycle.with_rider"
        else:
            if name == "pedestrian":
                return "pedestrian.standing"
            if name == "bus":
                return "vehicle.stopped"
        return DEFAULT_ATTRIBUTE.get(name, "")

    def gt_eval_frames(self, indices: Sequence[int]) -> Frames:
        """GT Frames for the NDS evaluator. The reference's info pickles
        carry no attribute names (the devkit reads them from the nusc DB),
        so attr_err degrades to NaN-per-box unless the infos include an
        optional `gt_attributes` list."""
        frames: Frames = {}
        for idx in indices:
            info = self.infos[idx]
            boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 9))),
                               np.float64)
            names = list(info.get("gt_names", ()))
            npts = np.asarray(info.get("num_lidar_pts",
                                       np.full(len(boxes), -1)))
            nusc = self._boxes_to_nusc(
                np.nan_to_num(boxes), names, info, None, npts)
            for b, attr in zip(nusc, info.get("gt_attributes",
                                              [""] * len(nusc))):
                b.attribute = attr
            frames[info["token"]] = nusc
        return frames

    def det_eval_frames(self, det_annos: Sequence[dict]) -> Frames:
        """det_annos: [{token, boxes_lidar (N, 7|9), name (N,), score (N,)}]
        -> global-frame prediction Frames for eval/nuscenes_eval.py."""
        by_token = {info["token"]: info for info in self.infos}
        frames: Frames = {}
        for det in det_annos:
            info = by_token[det["token"]]
            frames[det["token"]] = self._boxes_to_nusc(
                np.asarray(det["boxes_lidar"], np.float64),
                list(det["name"]), info,
                np.asarray(det["score"], np.float64), None)
        return frames

    def evaluation(self, det_annos: Sequence[dict],
                   indices: Optional[Sequence[int]] = None) -> Dict:
        """Run the NDS protocol over `det_annos`
        (nuscenes_dataset.py:153-207 without the devkit dependency)."""
        from ..eval.nuscenes_eval import evaluate
        idx = indices if indices is not None else range(len(self.infos))
        return evaluate(self.gt_eval_frames(idx),
                        self.det_eval_frames(det_annos),
                        class_names=self.class_names)
