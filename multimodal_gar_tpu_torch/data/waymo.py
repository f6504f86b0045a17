"""Waymo dataset adapter: info pickles, per-frame .npy lidar, sequences.

Capability parity with pcdet/datasets/waymo/waymo_dataset.py (SURVEY.md
§2.2 row 19). The reference's *runtime* path is SDK-free — the
waymo-open-dataset SDK is only used by its offline info-creation step
(get_infos:175-193) and the TF-based official evaluator — so this module
implements the runtime contract directly:

  - info pickles: [{point_cloud: {lidar_sequence, sample_idx}, frame_id,
    pose (4, 4), annos: {name, difficulty, gt_boxes_lidar (N, 7|9),
    num_points_in_gt}}];
  - lidar .npy per frame, (N, 6) [x y z intensity elongation NLZ_flag]:
    NLZ filtering + tanh(intensity) (waymo_dataset.get_lidar:196-203);
  - multi-frame sequence aggregation with ego-pose alignment, a 0.1 s/frame
    timestamp (or one-hot) channel, and ego-radius removal on past frames
    (get_sequence_data:246-333) — the MPPNet input path;
  - prior-box loading for MPPNet (transform_prebox_to_current:208-236,
    reorder_rois_for_refining:238-245);
  - 'kitti'-metric evaluation via name mapping (evaluation:407-430). The
    reference fabricates 50x50 2D bboxes so every object lands in the
    easiest KITTI difficulty bucket; difficulty 0 here reproduces that.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .processor import mask_points_outside_range

WAYMO_CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
MAP_NAME_TO_KITTI = {"Vehicle": "Car", "Pedestrian": "Pedestrian",
                     "Cyclist": "Cyclist", "Sign": "Sign", "Car": "Car"}


def transform_prebox_to_current(boxes: np.ndarray, pose_pre: np.ndarray,
                                pose_cur: np.ndarray) -> np.ndarray:
    """Move (N, 9|11) boxes from a past frame into the current frame
    (waymo_dataset.transform_prebox_to_current:208-236)."""
    boxes = boxes.copy()
    hom = np.concatenate([boxes[:, :3], np.ones((len(boxes), 1))], axis=-1)
    glob = hom @ pose_pre.T
    hom = np.concatenate([glob[:, :3], np.ones((len(boxes), 1))], axis=-1)
    boxes[:, :3] = (hom @ np.linalg.inv(pose_cur.T))[:, :3]
    if boxes.shape[-1] == 11:
        vel = np.concatenate([boxes[:, 7:9], np.zeros((len(boxes), 1))],
                             axis=-1)
        vel = vel @ pose_pre[:3, :3].T @ np.linalg.inv(pose_cur[:3, :3].T)
        boxes[:, 7:9] = vel[:, :2]
    boxes[:, 6] += np.arctan2(pose_pre[1, 0], pose_pre[0, 0])
    boxes[:, 6] -= np.arctan2(pose_cur[1, 0], pose_cur[0, 0])
    return boxes


def reorder_rois_for_refining(pred_boxes: List[np.ndarray]) -> np.ndarray:
    """Ragged per-frame box lists -> one padded (T, R, C) tensor."""
    rmax = max(1, max(len(b) for b in pred_boxes))
    out = np.zeros((len(pred_boxes), rmax, pred_boxes[0].shape[-1]),
                   np.float32)
    for i, b in enumerate(pred_boxes):
        out[i, :len(b)] = b
    return out


class WaymoDataset:
    """Info-pickle + processed-.npy Waymo adapter."""

    def __init__(self, root: str, info_paths: Sequence[str],
                 processed_data_tag: str = "waymo_processed_data",
                 class_names: Sequence[str] = WAYMO_CLASSES,
                 point_cloud_range: Sequence[float] = (
                     -75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 disable_nlz_flag: bool = False,
                 filter_empty_boxes: bool = False,
                 train_with_speed: bool = False,
                 sequence_offset: Optional[Sequence[int]] = None,
                 onehot_timestamp: bool = False,
                 pred_boxes_dict: Optional[Dict] = None):
        self.root = root
        self.data_path = os.path.join(root, processed_data_tag)
        self.class_names = tuple(class_names)
        self.range = np.asarray(point_cloud_range, np.float32)
        self.disable_nlz_flag = disable_nlz_flag
        self.filter_empty_boxes = filter_empty_boxes
        self.train_with_speed = train_with_speed
        self.sequence_offset = (tuple(sequence_offset)
                                if sequence_offset is not None else None)
        self.onehot_timestamp = onehot_timestamp
        self.pred_boxes_dict = pred_boxes_dict or {}
        self.infos: List[dict] = []
        for p in info_paths:
            path = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    self.infos.extend(pickle.load(f))
        self.seq_name_to_infos: Dict[str, Dict[int, dict]] = {}
        for info in self.infos:
            pc = info["point_cloud"]
            self.seq_name_to_infos.setdefault(
                pc["lidar_sequence"], {})[pc["sample_idx"]] = info

    def __len__(self) -> int:
        return len(self.infos)

    @property
    def num_point_features(self) -> int:
        base = 5
        if self.sequence_offset is None:
            return base
        if self.onehot_timestamp:
            n_prev = self.sequence_offset[1] - self.sequence_offset[0]
            return base + n_prev + 1
        return base + 1

    def get_lidar(self, sequence_name: str, sample_idx: int) -> np.ndarray:
        """(N, 5) with NLZ filtering + tanh intensity (get_lidar:196-203)."""
        path = os.path.join(self.data_path, sequence_name,
                            "%04d.npy" % sample_idx)
        feats = np.load(path)
        points, nlz = feats[:, 0:5], feats[:, 5]
        if not self.disable_nlz_flag:
            points = points[nlz == -1]
        points = points.copy()
        points[:, 3] = np.tanh(points[:, 3])
        return points

    def _load_pred_boxes(self, sequence_name: str,
                         sample_idx: int) -> np.ndarray:
        sequence_name = sequence_name.replace("training_", "").replace(
            "validation_", "")
        boxes = np.asarray(self.pred_boxes_dict[sequence_name][sample_idx],
                           np.float32).copy()
        boxes[:, 7:9] *= -0.1        # speed -> per-frame backward motion
        return boxes

    def get_sequence_data(self, info: dict, points: np.ndarray,
                          sequence_name: str, sample_idx: int,
                          load_pred_boxes: bool = False):
        """Aggregate SAMPLE_OFFSET past frames into the current frame
        (get_sequence_data:246-333)."""
        lo, hi = self.sequence_offset
        pose_cur = np.asarray(info["pose"], np.float64).reshape(4, 4)
        idx_pre = np.clip(sample_idx + np.arange(lo, hi), 0, 0x7FFFFFFF)
        idx_pre = idx_pre[::-1]
        n_prev = len(idx_pre)

        if self.onehot_timestamp:
            onehot = np.zeros((len(points), n_prev + 1), points.dtype)
            onehot[:, 0] = 1
            points = np.hstack([points, onehot])
        else:
            points = np.hstack(
                [points, np.zeros((len(points), 1), points.dtype)])

        seq_infos = self.seq_name_to_infos[sequence_name]
        pts_pre_all, num_pre, pose_all = [], [], [pose_cur]
        pred_all = []
        if load_pred_boxes:
            pred_all.append(self._load_pred_boxes(sequence_name, sample_idx))
        for k, i_pre in enumerate(idx_pre):
            p = self.get_lidar(sequence_name, int(i_pre))
            pose_pre = np.asarray(seq_infos[int(i_pre)]["pose"],
                                  np.float64).reshape(4, 4)
            hom = np.concatenate([p[:, :3], np.ones((len(p), 1))], axis=-1)
            glob = hom @ pose_pre.T
            hom = np.concatenate([glob[:, :3], np.ones((len(p), 1))],
                                 axis=-1)
            cur = (hom @ np.linalg.inv(pose_cur.T))[:, :3]
            p = np.concatenate([cur, p[:, 3:]], axis=-1)
            if self.onehot_timestamp:
                onehot = np.zeros((len(p), n_prev + 1))
                onehot[:, k + 1] = 1
                p = np.hstack([p, onehot])
            else:
                p = np.hstack([p, 0.1 * (sample_idx - i_pre)
                               * np.ones((len(p), 1))])
            mask = ~((np.abs(p[:, 0]) < 1.0) & (np.abs(p[:, 1]) < 1.0))
            p = p[mask]
            pts_pre_all.append(p)
            num_pre.append(len(p))
            pose_all.append(pose_pre)
            if load_pred_boxes:
                pred_all.append(transform_prebox_to_current(
                    self._load_pred_boxes(sequence_name, int(i_pre)),
                    pose_pre, pose_cur))

        points = np.concatenate([points] + pts_pre_all,
                                axis=0).astype(np.float32)
        num_all = np.array([len(points) - sum(num_pre)] + num_pre, np.int32)
        poses = np.concatenate(pose_all, axis=0).astype(np.float32)
        if load_pred_boxes:
            padded = reorder_rois_for_refining(pred_all)
            return (points, num_all, idx_pre, poses,
                    padded[:, :, 0:9], padded[:, :, 9], padded[:, :, 10])
        return points, num_all, idx_pre, poses, None, None, None

    def frame(self, idx: int, training: bool = False) -> Dict:
        info = self.infos[idx]
        pc = info["point_cloud"]
        seq, sample_idx = pc["lidar_sequence"], pc["sample_idx"]
        points = self.get_lidar(seq, sample_idx)
        out: Dict = {"frame_id": info["frame_id"],
                     "pose": np.asarray(info["pose"], np.float32)}
        if self.sequence_offset is not None:
            load_pred = bool(self.pred_boxes_dict)
            (points, num_all, _, poses, roi_boxes, roi_scores,
             roi_labels) = self.get_sequence_data(
                info, points, seq, sample_idx, load_pred_boxes=load_pred)
            out["poses"] = poses
            if load_pred:
                out.update(roi_boxes=roi_boxes, roi_scores=roi_scores,
                           roi_labels=roi_labels)
        out["points"] = mask_points_outside_range(points, self.range)

        annos = info.get("annos")
        if annos is not None:
            names = np.asarray(annos["name"])
            boxes = np.asarray(annos["gt_boxes_lidar"], np.float32)
            npts = np.asarray(annos.get("num_points_in_gt",
                                        np.full(len(names), -1)))
            keep = names != "unknown"
            if training and self.filter_empty_boxes:
                keep &= npts > 0
            names, boxes, npts = names[keep], boxes[keep], npts[keep]
            if not self.train_with_speed and boxes.shape[-1] > 7:
                boxes = boxes[:, :7]
            sel = [i for i, n in enumerate(names) if n in self.class_names]
            out["gt_boxes"] = boxes[sel]
            out["gt_names"] = [str(names[i]) for i in sel]
            out["gt_classes"] = np.asarray(
                [self.class_names.index(names[i]) + 1 for i in sel],
                np.int32)
            out["num_points_in_gt"] = npts[sel]
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
            rulebook_caps=rulebook_caps,
            num_features=self.num_point_features)

    def evaluation(self, det_annos: Sequence[dict],
                   eval_metric: str = "kitti",
                   indices: Optional[Sequence[int]] = None
                   ) -> Dict[str, float]:
        """'kitti' metric: map Waymo names to KITTI classes and run the
        R40 protocol on lidar boxes (waymo_dataset.evaluation:407-430).
        'waymo' metric: the official AP/APH protocol, reimplemented
        SDK-free from the public spec (eval/waymo_eval.py)."""
        if eval_metric == "waymo":
            return self._evaluation_waymo(det_annos, indices)
        if eval_metric != "kitti":
            raise NotImplementedError(eval_metric)
        from ..eval.kitti_eval import FrameAnnotations, evaluate
        # det_annos align POSITIONALLY with `indices` (default: all infos
        # in order). Pass the real_indices from registry.det_batches when
        # evaluating a shuffled/sharded subset — a bare zip against all
        # infos would silently score detections against the wrong frames.
        infos = (self.infos if indices is None
                 else [self.infos[i] for i in indices])
        if len(det_annos) != len(infos):
            raise ValueError(
                f"{len(det_annos)} det_annos vs {len(infos)} frames; pass "
                "indices= to align a subset")
        frames = []
        for det, info in zip(det_annos, infos):
            annos = info.get("annos", {})
            g_names = [MAP_NAME_TO_KITTI.get(str(n), str(n))
                       for n in annos.get("name", [])]
            g_boxes = np.asarray(annos.get("gt_boxes_lidar",
                                           np.zeros((0, 7))),
                                 np.float32)[:, :7]
            d_names = [MAP_NAME_TO_KITTI.get(str(n), str(n))
                       for n in det["name"]]
            frames.append(FrameAnnotations(
                gt_boxes=g_boxes, gt_names=g_names,
                # the reference fabricates 50-px bboxes: every GT is "easy"
                gt_difficulty=np.zeros(len(g_names), np.int32),
                det_boxes=np.asarray(det["boxes_lidar"],
                                     np.float32)[:, :7],
                det_names=d_names,
                det_scores=np.asarray(det["score"], np.float32)))
        kitti_classes = [MAP_NAME_TO_KITTI[c] for c in self.class_names
                         if c in MAP_NAME_TO_KITTI and c != "Sign"]
        return evaluate(frames, classes=kitti_classes)

    def _evaluation_waymo(self, det_annos: Sequence[dict],
                          indices: Optional[Sequence[int]] = None
                          ) -> Dict[str, float]:
        """Official Waymo AP/APH (waymo_eval.py:1-776 semantics), SDK-free."""
        from ..eval.waymo_eval import WaymoFrame, evaluate

        infos = (self.infos if indices is None
                 else [self.infos[i] for i in indices])
        if len(det_annos) != len(infos):
            raise ValueError(
                f"{len(det_annos)} det_annos vs {len(infos)} frames; pass "
                "indices= to align a subset")
        frames = []
        for det, info in zip(det_annos, infos):
            annos = info.get("annos", {})
            names = [str(n) for n in annos.get("name", [])]
            g = len(names)
            frames.append(WaymoFrame(
                gt_boxes=np.asarray(
                    annos.get("gt_boxes_lidar", np.zeros((0, 7))),
                    np.float32)[:, :7],
                gt_types=names,
                gt_difficulty=np.asarray(
                    annos.get("difficulty", np.zeros(g)), np.int32),
                gt_num_points=np.asarray(
                    annos.get("num_points_in_gt", np.full(g, 6)), np.int64),
                det_boxes=np.asarray(det["boxes_lidar"], np.float32)[:, :7],
                det_types=[str(n) for n in det["name"]],
                det_scores=np.asarray(det["score"], np.float32)))
        classes = [c for c in self.class_names if c != "Sign"]
        return evaluate(frames, classes=classes)
