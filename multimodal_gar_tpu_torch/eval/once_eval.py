"""ONCE detection AP evaluation, host-side numpy.

Capability parity with pcdet/datasets/once/once_eval/evaluation.py
(get_evaluation_results:26-150): 3D rotated IoU with a heading gate
(ap_with_heading — predictions facing >90 degrees away cannot match),
superclass merging (Car/Bus/Truck -> Vehicle), four difficulty buckets
(overall, 0-30m, 30-50m, 50m-inf by BEV center distance), per-class IoU
thresholds (Vehicle 0.7, Pedestrian 0.3, Cyclist 0.5), and a 50-point
interpolated PR curve using the same recall-crossing threshold sampling as
the KITTI devkit.

Reuses the convex-clipping IoU from eval/kitti_eval.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .kitti_eval import iou_3d

SUPERCLASS_IOU = {"Vehicle": 0.7, "Pedestrian": 0.3, "Cyclist": 0.5}
CLASS_IOU = {"Car": 0.7, "Bus": 0.7, "Truck": 0.7,
             "Pedestrian": 0.3, "Cyclist": 0.5}
SUPERCLASS = {"Car": "Vehicle", "Bus": "Vehicle", "Truck": "Vehicle"}
DIFFICULTIES = ("overall", "0-30m", "30-50m", "50m-inf")
NUM_PR_POINTS = 50


@dataclasses.dataclass
class OnceFrame:
    gt_boxes: np.ndarray      # (G, 7)
    gt_names: List[str]
    det_boxes: np.ndarray     # (D, 7)
    det_names: List[str]
    det_scores: np.ndarray    # (D,)


def _heading_gated_iou(gt: np.ndarray, det: np.ndarray) -> np.ndarray:
    iou = iou_3d(gt, det)
    if len(gt) and len(det):
        diff = np.abs(gt[:, None, 6] - det[None, :, 6]) % (2 * np.pi)
        diff = np.minimum(diff, 2 * np.pi - diff)
        iou = np.where(diff <= np.pi / 2, iou, -1.0)
    return iou


def _dist_bucket(boxes: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(boxes[:, :2], axis=1)
    return np.where(d < 30, 1, np.where(d < 50, 2, 3))


def _flags(frame: OnceFrame, cls: str, diff: int, use_superclass: bool):
    """gt/det flags: 0 scored, 1 ignored, -1 other class
    (once_eval filter_data:258-300)."""
    def name_match(n):
        return (SUPERCLASS.get(n, n) if use_superclass else n) == cls

    gt_flag = np.full(len(frame.gt_names), -1, np.int32)
    det_flag = np.full(len(frame.det_names), -1, np.int32)
    gt_b = _dist_bucket(frame.gt_boxes) if len(frame.gt_names) else \
        np.zeros(0, np.int32)
    det_b = _dist_bucket(frame.det_boxes) if len(frame.det_names) else \
        np.zeros(0, np.int32)
    for i, n in enumerate(frame.gt_names):
        if name_match(n):
            gt_flag[i] = 0 if (diff == 0 or gt_b[i] == diff) else 1
    for i, n in enumerate(frame.det_names):
        if name_match(n):
            det_flag[i] = 0 if (diff == 0 or det_b[i] == diff) else 1
    return gt_flag, det_flag


def _tp_scores(iou, scores, gt_flag, det_flag, thr):
    """Devkit accumulate_scores (evaluation.py:177-208): every same-class
    GT (scored OR ignored) claims its max-SCORE unassigned detection with
    iou strictly > thr; ignored GTs/dets consume without emitting."""
    out = []
    assigned = np.zeros(len(det_flag), bool)
    for i in range(len(gt_flag)):
        if gt_flag[i] == -1:
            continue
        bj, best_score = -1, -1.0
        for j in range(len(det_flag)):
            if det_flag[j] == -1 or assigned[j]:
                continue
            if iou[i, j] > thr and scores[j] > best_score:
                best_score, bj = scores[j], j
        if bj < 0:
            continue
        assigned[bj] = True
        if gt_flag[i] == 0 and det_flag[bj] == 0:
            out.append(float(scores[bj]))
    return out


def _stats(iou, scores, gt_flag, det_flag, score_th, thr):
    """Devkit compute_statistics (evaluation.py:211-255): scored dets are
    matched by max iou (strict > thr); an ignored det can hold a GT until
    a scored det displaces it; ignored GTs/dets consume their match;
    FPs are unassigned scored dets above the score threshold."""
    under = scores < score_th
    assigned = np.zeros(len(det_flag), bool)
    tp = fn = 0
    for i in range(len(gt_flag)):
        if gt_flag[i] == -1:
            continue
        det_idx, detected, best_iou, on_ignore = -1, False, 0.0, False
        for j in range(len(det_flag)):
            if det_flag[j] == -1 or assigned[j] or under[j]:
                continue
            ov = iou[i, j]
            if ov > thr and (ov > best_iou or on_ignore) \
                    and det_flag[j] == 0:
                best_iou, det_idx, detected, on_ignore = ov, j, True, False
            elif ov > thr and not detected and det_flag[j] == 1:
                det_idx, detected, on_ignore = j, True, True
        if not detected:
            if gt_flag[i] == 0:
                fn += 1
        elif gt_flag[i] == 1 or det_flag[det_idx] == 1:
            assigned[det_idx] = True
        else:
            assigned[det_idx] = True
            tp += 1
    fp = int(((det_flag == 0) & ~under & ~assigned).sum())
    return tp, fp, fn


def _thresholds(scores: Sequence[float], num_gt: int) -> List[float]:
    """Devkit get_thresholds (evaluation.py:153-174) including the
    duplicate-padding loop: when one detection crosses several 1/50
    recall levels, its score fills every crossed slot so precision
    samples stay aligned with their recall grid positions."""
    eps = 1e-6
    scores = np.sort(np.asarray(scores))[::-1]
    out: List[float] = []
    recall_level = 0.0
    for i, s in enumerate(scores):
        l_rec = (i + 1) / max(num_gt, 1)
        r_rec = (i + 2) / max(num_gt, 1) if i < len(scores) - 1 else l_rec
        if (r_rec + l_rec < 2 * recall_level) and i < len(scores) - 1:
            continue
        out.append(float(s))
        recall_level += 1.0 / NUM_PR_POINTS
        while r_rec + l_rec + eps > 2 * recall_level:
            out.append(float(s))
            recall_level += 1.0 / NUM_PR_POINTS
    return out


def evaluate_once(frames: Sequence[OnceFrame],
                  classes: Sequence[str] = ("Vehicle", "Pedestrian",
                                            "Cyclist"),
                  use_superclass: bool = True) -> Dict[str, float]:
    """-> {"AP_<cls>/<difficulty>": ap, "AP_mean/<difficulty>": map}."""
    ious = [_heading_gated_iou(f.gt_boxes, f.det_boxes) for f in frames]
    thr_table = SUPERCLASS_IOU if use_superclass else CLASS_IOU
    out: Dict[str, float] = {}
    per_diff: Dict[str, List[float]] = {d: [] for d in DIFFICULTIES}
    for cls in classes:
        thr = thr_table[cls]
        for diff, dname in enumerate(DIFFICULTIES):
            flags = [_flags(f, cls, diff, use_superclass) for f in frames]
            num_gt = sum(int((g == 0).sum()) for g, _ in flags)
            scores: List[float] = []
            for f, iou, (g, d) in zip(frames, ious, flags):
                scores += _tp_scores(iou, f.det_scores, g, d, thr)
            if num_gt == 0:
                ap = 0.0
            else:
                ths = _thresholds(scores, num_gt)
                prec = np.zeros(NUM_PR_POINTS + 1)
                for k, t in enumerate(ths[:NUM_PR_POINTS + 1]):
                    tp = fp = fn = 0
                    for f, iou, (g, d) in zip(frames, ious, flags):
                        a, b, c = _stats(iou, f.det_scores, g, d, t, thr)
                        tp, fp, fn = tp + a, fp + b, fn + c
                    prec[k] = tp / max(tp + fp, 1)
                for k in range(NUM_PR_POINTS - 1, -1, -1):
                    prec[k] = max(prec[k], prec[k + 1])
                ap = float(prec[1:].sum() / NUM_PR_POINTS * 100.0)
            out[f"AP_{cls}/{dname}"] = ap
            per_diff[dname].append(ap)
    for dname, vals in per_diff.items():
        out[f"AP_mean/{dname}"] = float(np.mean(vals)) if vals else 0.0
    return out
