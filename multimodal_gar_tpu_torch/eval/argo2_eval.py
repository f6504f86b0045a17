"""Argoverse 2 detection evaluation (CDS protocol), host-side numpy.

Capability parity with the eval path the reference drives through the av2
SDK at pcdet/datasets/argo2/argo2_dataset.py:269-330 (av2.evaluation.
detection.eval.evaluate with the competition DetectionCfg). The SDK is not
installed in this image, so the protocol is reimplemented from its public
specification:

  - per-category AP with greedy 3D-center-distance matching at
    {0.5, 1, 2, 4} m (descending score, one match per GT per threshold),
    precision envelope interpolated onto a 101-point recall grid;
  - true-positive errors at the 2 m threshold: ATE (3D translation, m),
    ASE (1 - aligned scale IoU), AOE (minimal yaw difference, rad),
    averaged over TPs — defaulting to the normalization bounds when a
    category has no TPs;
  - CDS = AP x mean(1 - ATE/2, 1 - ASE, 1 - AOE/pi);
  - GT filtering by range (max_range_m) and interior-point count.

Box convention here is the framework's lidar 7-dof (cx cy cz dx dy dz
yaw); the feather-file attribute order (tx ty tz length width height quat,
argo2_utils/constants.py LABEL_ATTR) is handled by the adapter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

COMPETITION_CATEGORIES = (
    "REGULAR_VEHICLE", "PEDESTRIAN", "BICYCLIST", "MOTORCYCLIST",
    "WHEELED_RIDER", "BOLLARD", "CONSTRUCTION_CONE", "SIGN",
    "CONSTRUCTION_BARREL", "STOP_SIGN", "MOBILE_PEDESTRIAN_CROSSING_SIGN",
    "LARGE_VEHICLE", "BUS", "BOX_TRUCK", "TRUCK", "VEHICULAR_TRAILER",
    "TRUCK_CAB", "SCHOOL_BUS", "ARTICULATED_BUS", "MESSAGE_BOARD_TRAILER",
    "BICYCLE", "MOTORCYCLE", "WHEELED_DEVICE", "WHEELCHAIR", "STROLLER",
    "DOG")

AFFINITY_THRESHOLDS_M = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD_M = 2.0
# normalization bounds for (ATE, ASE, AOE)
NORM_TERMS = (TP_THRESHOLD_M, 1.0, np.pi)
_N_REC = 101


@dataclasses.dataclass
class Argo2Frame:
    """One (log_id, timestamp) sweep's GT + detections, lidar frame."""
    gt_boxes: np.ndarray       # (G, 7)
    gt_names: List[str]
    det_boxes: np.ndarray      # (D, 7)
    det_names: List[str]
    det_scores: np.ndarray     # (D,)
    gt_num_interior_pts: np.ndarray = None  # (G,) optional

    def __post_init__(self):
        if self.gt_num_interior_pts is None:
            self.gt_num_interior_pts = np.full(len(self.gt_names), -1)


def filter_frames(frames: Sequence[Argo2Frame],
                  max_range_m: float = 150.0) -> List[Argo2Frame]:
    """Range + interior-point GT filtering (av2 DetectionCfg defaults)."""
    out = []
    for f in frames:
        if len(f.gt_boxes):
            dist = np.linalg.norm(f.gt_boxes[:, :3], axis=1)
            keep = (dist <= max_range_m) & (f.gt_num_interior_pts != 0)
        else:
            keep = np.zeros(0, bool)
        dkeep = (np.linalg.norm(f.det_boxes[:, :3], axis=1) <= max_range_m
                 if len(f.det_boxes) else np.zeros(0, bool))
        out.append(Argo2Frame(
            gt_boxes=f.gt_boxes[keep],
            gt_names=[n for n, k in zip(f.gt_names, keep) if k],
            det_boxes=f.det_boxes[dkeep],
            det_names=[n for n, k in zip(f.det_names, dkeep) if k],
            det_scores=f.det_scores[dkeep],
            gt_num_interior_pts=f.gt_num_interior_pts[keep]))
    return out


def _scale_iou(a: np.ndarray, b: np.ndarray) -> float:
    sa, sb = np.maximum(a[3:6], 0), np.maximum(b[3:6], 0)
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa) + np.prod(sb) - inter)
    return inter / union if union > 0 else 0.0


def _yaw_err(a: float, b: float) -> float:
    d = (a - b) % (2 * np.pi)
    return float(min(d, 2 * np.pi - d))


def _interp_ap(tp: np.ndarray, fp: np.ndarray, npos: int) -> float:
    if npos == 0 or len(tp) == 0:
        return 0.0
    tp_c, fp_c = np.cumsum(tp), np.cumsum(fp)
    rec = tp_c / npos
    prec = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    # monotone precision envelope
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    grid = np.linspace(0, 1, _N_REC)
    prec_i = np.interp(grid, rec, prec, right=0)
    return float(np.mean(prec_i))


def _match_category(frames: Sequence[Argo2Frame], cat: str,
                    dist_th: float, collect_errors: bool):
    """Greedy per-frame matching; returns (tp, fp arrays sorted by score,
    npos, error triplets of the TPs)."""
    npos = sum(sum(1 for n in f.gt_names if n == cat) for f in frames)
    preds = []
    for fi, f in enumerate(frames):
        for di, n in enumerate(f.det_names):
            if n == cat:
                preds.append((float(f.det_scores[di]), fi, di))
    preds.sort(key=lambda x: -x[0])
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    errors = []
    taken = set()
    for pi, (_, fi, di) in enumerate(preds):
        f = frames[fi]
        d = f.det_boxes[di]
        best, gj = np.inf, -1
        for gi, n in enumerate(f.gt_names):
            if n == cat and (fi, gi) not in taken:
                dist = float(np.linalg.norm(f.gt_boxes[gi, :3] - d[:3]))
                if dist < best:
                    best, gj = dist, gi
        if best < dist_th:
            taken.add((fi, gj))
            tp[pi] = 1
            if collect_errors:
                g = f.gt_boxes[gj]
                errors.append((best if dist_th == TP_THRESHOLD_M
                               else float(np.linalg.norm(g[:3] - d[:3])),
                               1.0 - _scale_iou(g, d),
                               _yaw_err(g[6], d[6])))
        else:
            fp[pi] = 1
    return tp, fp, npos, errors


def evaluate(frames: Sequence[Argo2Frame],
             categories: Sequence[str] = COMPETITION_CATEGORIES,
             max_range_m: float = 150.0,
             filter_by_range: bool = True) -> Dict:
    """Full CDS evaluation -> {category: {AP, ATE, ASE, AOE, CDS}, plus
    mAP / mATE / mASE / mAOE / mCDS means over evaluated categories}."""
    if filter_by_range:
        frames = filter_frames(frames, max_range_m)
    per_cat: Dict[str, Dict[str, float]] = {}
    for cat in categories:
        npos = sum(sum(1 for n in f.gt_names if n == cat) for f in frames)
        if npos == 0:
            continue
        aps = []
        errors = []
        for th in AFFINITY_THRESHOLDS_M:
            tp, fp, _, errs = _match_category(
                frames, cat, th, collect_errors=(th == TP_THRESHOLD_M))
            aps.append(_interp_ap(tp, fp, npos))
            if th == TP_THRESHOLD_M:
                errors = errs
        ap = float(np.mean(aps))
        if errors:
            ate, ase, aoe = (float(np.mean([e[i] for e in errors]))
                             for i in range(3))
        else:
            ate, ase, aoe = NORM_TERMS          # worst-case defaults
        cds = ap * float(np.mean([1 - ate / NORM_TERMS[0],
                                  1 - ase / NORM_TERMS[1],
                                  1 - aoe / NORM_TERMS[2]]))
        per_cat[cat] = {"AP": ap, "ATE": ate, "ASE": ase, "AOE": aoe,
                        "CDS": cds}
    out: Dict = dict(per_cat)
    if per_cat:
        for key, mkey in (("AP", "mAP"), ("ATE", "mATE"), ("ASE", "mASE"),
                          ("AOE", "mAOE"), ("CDS", "mCDS")):
            out[mkey] = float(np.mean([v[key] for v in per_cat.values()]))
    else:
        out.update(mAP=0.0, mATE=NORM_TERMS[0], mASE=1.0,
                   mAOE=float(np.pi), mCDS=0.0)
    return out
