"""Lyft level-5 detection mAP evaluation, host-side numpy.

Capability parity with the evaluator the reference vendors at
pcdet/datasets/lyft/lyft_mAP_eval/lyft_eval.py (driven from
lyft_dataset.lyft_eval:145-160): per class and per IoU threshold, greedy
match each prediction (descending score) to its max-IoU GT in the sample —
with the protocol's quirk that an already-matched argmax GT makes the
prediction a false positive (no second-best fallback) and the comparison
is strictly `>` — then VOC-style envelope area under the raw PR points,
averaged over the IoU-threshold list per class.

Box overlap is the same rotated-BEV-area x height-overlap 3D IoU the
vendored Box3D.get_iou computes via shapely; here boxes are lidar-frame
(cx cy cz dx dy dz yaw) and reuse eval/kitti_eval.iou_3d's convex clip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .kitti_eval import iou_3d

LYFT_CLASSES = ("car", "other_vehicle", "pedestrian", "bicycle", "truck",
                "bus", "motorcycle", "animal", "emergency_vehicle")
DEFAULT_IOU_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)


@dataclasses.dataclass
class LyftFrame:
    gt_boxes: np.ndarray       # (G, 7)
    gt_names: List[str]
    det_boxes: np.ndarray      # (D, 7)
    det_names: List[str]
    det_scores: np.ndarray     # (D,)


def _envelope_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """VOC-correct AP: precision envelope, sum of recall-step areas."""
    rec = np.concatenate(([0.0], recalls, [1.0]))
    prec = np.concatenate(([0.0], precisions, [0.0]))
    for i in range(prec.size - 1, 0, -1):
        prec[i - 1] = max(prec[i - 1], prec[i])
    steps = np.where(rec[1:] != rec[:-1])[0]
    return float(np.sum((rec[steps + 1] - rec[steps]) * prec[steps + 1]))


def _class_ap(frames: Sequence[LyftFrame], cls: str,
              iou_thresholds: Sequence[float]) -> float:
    num_gts = sum(sum(1 for n in f.gt_names if n == cls) for f in frames)
    if num_gts == 0:
        return 0.0
    preds = []   # (score, frame_idx, det_idx)
    for fi, f in enumerate(frames):
        for di, n in enumerate(f.det_names):
            if n == cls:
                preds.append((float(f.det_scores[di]), fi, di))
    if not preds:
        return 0.0
    preds.sort(key=lambda x: -x[0])

    gt_idx = [np.asarray([i for i, n in enumerate(f.gt_names) if n == cls],
                         np.int64) for f in frames]
    checked = [np.zeros((len(g), len(iou_thresholds)), bool)
               for g in gt_idx]
    # one (G_cls, D) IoU matrix per frame up front — per-prediction
    # iou_3d calls rebuilt every GT polygon O(D) times
    iou_cache = [iou_3d(f.gt_boxes[g], f.det_boxes)
                 if len(g) and len(f.det_boxes) else np.zeros((len(g), 0))
                 for f, g in zip(frames, gt_idx)]
    nt = len(iou_thresholds)
    tp = np.zeros((len(preds), nt))
    fp = np.zeros((len(preds), nt))
    for pi, (_, fi, di) in enumerate(preds):
        g = gt_idx[fi]
        if len(g) > 0:
            ious = iou_cache[fi][:, di]
            jmax = int(np.argmax(ious))
            max_ov = float(ious[jmax])
        else:
            jmax, max_ov = -1, -np.inf
        for ti, th in enumerate(iou_thresholds):
            if max_ov > th:
                if not checked[fi][jmax, ti]:
                    tp[pi, ti] = 1.0
                    checked[fi][jmax, ti] = True
                else:
                    fp[pi, ti] = 1.0
            else:
                fp[pi, ti] = 1.0
    tp = np.cumsum(tp, axis=0)
    fp = np.cumsum(fp, axis=0)
    recalls = tp / float(num_gts)
    precisions = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return float(np.mean([_envelope_ap(recalls[:, i], precisions[:, i])
                          for i in range(nt)]))


def get_average_precisions(
        frames: Sequence[LyftFrame],
        class_names: Sequence[str] = LYFT_CLASSES,
        iou_thresholds: Sequence[float] = DEFAULT_IOU_THRESHOLDS
) -> np.ndarray:
    """Per-class AP averaged over `iou_thresholds`
    (lyft_eval.get_average_precisions:345-394)."""
    return np.asarray([_class_ap(frames, c, iou_thresholds)
                       for c in class_names])


def format_lyft_results(aps: np.ndarray, class_names: Sequence[str],
                        iou_thresholds: Sequence[float]) -> Dict:
    out = {f"AP_{c}": float(a) for c, a in zip(class_names, aps)}
    out["mAP"] = float(np.mean(aps))
    out["iou_thresholds"] = list(iou_thresholds)
    return out
