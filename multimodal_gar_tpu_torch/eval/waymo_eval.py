"""Waymo Open Dataset detection metric (AP / APH), SDK-free.

Capability parity with the reference's TF/SDK evaluator
(/root/reference/pcdet/datasets/waymo/waymo_eval.py:1-776,
OpenPCDetWaymoDetectionMetricsEstimator), reimplemented in numpy from the
public Waymo metric specification — the same from-spec approach as the NDS
(eval/nuscenes_eval.py) and Argoverse-2 CDS (eval/argo2_eval.py) protocols:

  - classes Vehicle / Pedestrian / Sign / Cyclist with per-class 3D IoU
    thresholds 0.7 / 0.5 / 0.5 / 0.5 (the reference's metrics_pb2 config);
  - LEVEL_1 / LEVEL_2 difficulty breakdown; ground truths with recorded
    difficulty 0 are reassigned by point count (>5 points -> L1, else L2)
    and zero-point boxes dropped, matching waymo_eval.py:44-50;
  - 101 score cutoffs (0.00..0.99, 1.0); at each cutoff detections are
    Hungarian-matched (maximum total IoU over pairs above the class
    threshold — TYPE_HUNGARIAN) and precision/recall accumulated over all
    frames;
  - AP = sum over the recall-sorted operating points of
    (r_i - r_{i-1}) * p_i with precision made monotone non-increasing in
    recall (conservative right-point integration; the official C++
    additionally caps recall jumps at delta=0.05 with the lower endpoint's
    precision — a second-order correction not reproduced here, documented
    deviation);
  - APH weights every true positive by its heading accuracy
    1 - |wrap(theta_det - theta_gt)| / pi in BOTH the precision and recall
    numerators.

Ground truths with difficulty above the level are ignored: they may absorb
a matched detection (which then counts neither TP nor FP) but are never
false negatives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .kitti_eval import iou_3d

WAYMO_CLASSES = ("Vehicle", "Pedestrian", "Sign", "Cyclist")
CLASS_IOU = {"Vehicle": 0.7, "Pedestrian": 0.5, "Sign": 0.5, "Cyclist": 0.5}
SCORE_CUTOFFS = np.concatenate([np.arange(100) * 0.01, [1.0]])


@dataclasses.dataclass
class WaymoFrame:
    """One frame's GT + detections (boxes are center-based
    [x, y, z, dx, dy, dz, heading] lidar boxes)."""
    gt_boxes: np.ndarray            # (G, 7)
    gt_types: List[str]
    gt_difficulty: np.ndarray       # (G,) int, 0 = unset
    gt_num_points: np.ndarray       # (G,) int
    det_boxes: np.ndarray           # (D, 7)
    det_types: List[str]
    det_scores: np.ndarray          # (D,)


def effective_difficulty(diff: np.ndarray, npts: np.ndarray) -> np.ndarray:
    """waymo_eval.py:44-48: unset (0) difficulty becomes 1 if the box holds
    more than 5 lidar points, else 2. Returns -1 for zero-point boxes
    (dropped from evaluation entirely)."""
    out = np.asarray(diff, np.int32).copy()
    npts = np.asarray(npts)
    unset = out == 0
    out[unset & (npts > 5)] = 1
    out[unset & (npts <= 5)] = 2
    out[npts <= 0] = -1
    return out


def _heading_accuracy(det_h: np.ndarray, gt_h: np.ndarray) -> np.ndarray:
    d = det_h - gt_h
    d = np.abs(d - np.floor(d / (2 * np.pi) + 0.5) * 2 * np.pi)
    return np.clip(1.0 - d / np.pi, 0.0, 1.0)


def _match(iou: np.ndarray, eligible_det: np.ndarray, thr: float):
    """TYPE_HUNGARIAN: maximize total IoU over pairs above ``thr`` among
    eligible detections. Returns list of (gt_idx, det_idx) pairs."""
    from scipy.optimize import linear_sum_assignment

    g, d = iou.shape
    det_idx = np.flatnonzero(eligible_det)
    if g == 0 or det_idx.size == 0:
        return []
    sub = iou[:, det_idx]
    cost = np.where(sub >= thr, -sub, 1.0)       # infeasible pairs cost > 0
    rows, cols = linear_sum_assignment(cost)
    return [(int(r), int(det_idx[c])) for r, c in zip(rows, cols)
            if sub[r, c] >= thr]


def eval_class(frames: Sequence[WaymoFrame], cls: str, level: int,
               iou_threshold: Optional[float] = None) -> Dict[str, float]:
    """AP / APH for one (class, LEVEL_k)."""
    thr = iou_threshold if iou_threshold is not None else CLASS_IOU[cls]
    per_frame = []
    num_gt = 0
    for f in frames:
        gsel = np.asarray([t == cls for t in f.gt_types], bool)
        diff = effective_difficulty(f.gt_difficulty, f.gt_num_points)
        gsel &= diff > 0
        dsel = np.asarray([t == cls for t in f.det_types], bool)
        gb = f.gt_boxes[gsel]
        db = f.det_boxes[dsel]
        scored = diff[gsel] <= level                 # else: ignored
        num_gt += int(scored.sum())
        iou = iou_3d(gb, db) if len(gb) and len(db) else \
            np.zeros((len(gb), len(db)), np.float32)
        hacc = _heading_accuracy(db[None, :, 6] if len(db) else
                                 np.zeros((1, 0)),
                                 gb[:, None, 6] if len(gb) else
                                 np.zeros((0, 1)))
        per_frame.append((iou, hacc, scored, f.det_scores[dsel]))

    if num_gt == 0:
        return {"ap": 0.0, "aph": 0.0}

    pr = []                                          # (recall, p, rh, ph)
    for cutoff in SCORE_CUTOFFS:
        tp = fp = 0
        tph = 0.0
        for iou, hacc, scored, scores in per_frame:
            elig = scores >= cutoff
            pairs = _match(iou, elig, thr)
            matched_det = np.zeros(iou.shape[1], bool)
            for gi, di in pairs:
                matched_det[di] = True
                if scored[gi]:
                    tp += 1
                    tph += float(hacc[gi, di])
            fp += int((elig & ~matched_det).sum())
        denom = max(tp + fp, 1)
        pr.append((tp / num_gt, tp / denom, tph / num_gt, tph / denom))

    def integrate(recalls, precisions):
        order = np.argsort(recalls)
        r = np.asarray(recalls)[order]
        p = np.asarray(precisions)[order]
        for i in range(len(p) - 2, -1, -1):          # monotone from right
            p[i] = max(p[i], p[i + 1])
        prev = 0.0
        ap = 0.0
        for ri, pi in zip(r, p):
            ap += (ri - prev) * pi
            prev = ri
        return ap

    ap = integrate([x[0] for x in pr], [x[1] for x in pr])
    aph = integrate([x[2] for x in pr], [x[3] for x in pr])
    return {"ap": ap * 100.0, "aph": aph * 100.0}


def evaluate(frames: Sequence[WaymoFrame],
             classes: Sequence[str] = ("Vehicle", "Pedestrian", "Cyclist"),
             levels: Sequence[int] = (1, 2)) -> Dict[str, float]:
    """Full result table {"<cls>_L<k>_AP(H)": value} plus per-level means
    (the official OBJECT_TYPE breakdown)."""
    out: Dict[str, float] = {}
    for lv in levels:
        aps, aphs = [], []
        for cls in classes:
            res = eval_class(frames, cls, lv)
            out[f"{cls}_L{lv}_AP"] = res["ap"]
            out[f"{cls}_L{lv}_APH"] = res["aph"]
            aps.append(res["ap"])
            aphs.append(res["aph"])
        out[f"mean_L{lv}_AP"] = float(np.mean(aps)) if aps else 0.0
        out[f"mean_L{lv}_APH"] = float(np.mean(aphs)) if aphs else 0.0
    return out
