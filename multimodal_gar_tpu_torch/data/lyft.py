"""Lyft level-5 dataset adapter: info pickles + multi-sweep .bin lidar.

Capability parity with pcdet/datasets/lyft/{lyft_dataset,lyft_utils}.py
(SURVEY.md §2.2 row 19). The runtime path mirrors the nuScenes adapter —
info pickles + raw float32 .bin reads — with Lyft's two quirks
(lyft_dataset.py:42-79): .bin files may carry a ragged tail that must be
truncated to a multiple of 5 floats, and there is no CBGS resampling or
num-lidar-pts filtering.

Evaluation modes match lyft_dataset.evaluation:134-143: 'kitti' maps Lyft
names onto KITTI classes (car->Car, truck->Truck, bicycle/motorcycle->
Cyclist) and runs the R40 protocol; 'lyft' runs the vendored mAP protocol
(eval/lyft_eval.py) over an IoU-threshold list.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Dict, List, Sequence

import numpy as np

from .processor import mask_points_outside_range

from ..eval.lyft_eval import LYFT_CLASSES, LyftFrame

MAP_NAME_TO_KITTI = {"car": "Car", "pedestrian": "Pedestrian",
                     "truck": "Truck", "bicycle": "Cyclist",
                     "motorcycle": "Cyclist"}


class LyftDataset:
    def __init__(self, root: str, info_paths: Sequence[str],
                 class_names: Sequence[str] = LYFT_CLASSES,
                 max_sweeps: int = 1,
                 point_cloud_range: Sequence[float] = (
                     -80.0, -80.0, -5.0, 80.0, 80.0, 3.0),
                 seed: int = 0):
        self.root = root
        self.class_names = tuple(class_names)
        self.max_sweeps = max_sweeps
        self.range = np.asarray(point_cloud_range, np.float32)
        self.rng = np.random.default_rng(seed)
        self.infos: List[dict] = []
        for p in info_paths:
            path = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    self.infos.extend(pickle.load(f))

    def __len__(self) -> int:
        return len(self.infos)

    def _read_bin(self, rel_path: str) -> np.ndarray:
        """Ragged-tail-tolerant (N, 5)[:, :4] read (lyft_dataset.py:44-48,
        60-64) — some Lyft dumps end mid-record."""
        path = os.path.join(self.root, rel_path)
        raw = np.fromfile(path, dtype=np.float32)
        raw = raw[:len(raw) - (len(raw) % 5)]
        return raw.reshape(-1, 5)[:, :4]

    def get_sweep(self, sweep: dict):
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
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                           np.float32)
        names = list(info.get("gt_names", ()))
        sel = [i for i, n in enumerate(names) if n in self.class_names]
        return {"frame_id": os.path.splitext(
                    os.path.basename(info["lidar_path"]))[0],
                "token": info.get("token", ""),
                "points": pts,
                "gt_boxes": boxes[sel][:, :7] if len(sel)
                else np.zeros((0, 7), np.float32),
                "gt_classes": np.asarray(
                    [self.class_names.index(names[i]) + 1 for i in sel],
                    np.int32),
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

    def evaluation(self, det_annos: Sequence[dict],
                   eval_metric: str = "lyft",
                   iou_thresholds: Sequence[float] = (0.5, 0.6, 0.7,
                                                      0.8, 0.9),
                   indices: Optional[Sequence[int]] = None) -> Dict:
        # positional alignment guard — see WaymoDataset.evaluation
        infos = (self.infos if indices is None
                 else [self.infos[i] for i in indices])
        if len(det_annos) != len(infos):
            raise ValueError(
                f"{len(det_annos)} det_annos vs {len(infos)} frames; pass "
                "indices= to align a subset")
        if eval_metric == "lyft":
            from ..eval.lyft_eval import (format_lyft_results,
                                          get_average_precisions)
            frames = []
            for det, info in zip(det_annos, infos):
                frames.append(LyftFrame(
                    gt_boxes=np.asarray(info.get("gt_boxes",
                                                 np.zeros((0, 7))),
                                        np.float32)[:, :7],
                    gt_names=list(info.get("gt_names", ())),
                    det_boxes=np.asarray(det["boxes_lidar"],
                                         np.float32)[:, :7],
                    det_names=list(det["name"]),
                    det_scores=np.asarray(det["score"], np.float32)))
            aps = get_average_precisions(frames, self.class_names,
                                         iou_thresholds)
            return format_lyft_results(aps, self.class_names,
                                       iou_thresholds)
        if eval_metric == "kitti":
            from ..eval.kitti_eval import FrameAnnotations, evaluate
            frames = []
            for det, info in zip(det_annos, infos):
                g_names = [MAP_NAME_TO_KITTI.get(str(n), str(n))
                           for n in info.get("gt_names", ())]
                frames.append(FrameAnnotations(
                    gt_boxes=np.asarray(info.get("gt_boxes",
                                                 np.zeros((0, 7))),
                                        np.float32)[:, :7],
                    gt_names=g_names,
                    gt_difficulty=np.zeros(len(g_names), np.int32),
                    det_boxes=np.asarray(det["boxes_lidar"],
                                         np.float32)[:, :7],
                    det_names=[MAP_NAME_TO_KITTI.get(str(n), str(n))
                               for n in det["name"]],
                    det_scores=np.asarray(det["score"], np.float32)))
            classes = sorted({MAP_NAME_TO_KITTI[c] for c in self.class_names
                              if c in MAP_NAME_TO_KITTI})
            return evaluate(frames, classes=classes)
        raise NotImplementedError(eval_metric)
