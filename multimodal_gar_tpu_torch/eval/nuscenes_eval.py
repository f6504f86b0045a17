"""nuScenes detection evaluation (NDS protocol), host-side numpy.

Capability parity with the eval path the reference drives through the
nuscenes devkit at pcdet/datasets/nuscenes/nuscenes_dataset.py:153-207
(NuScenesEval with the `detection_cvpr_2019` config). The devkit is not
installed in this image, so the protocol is reimplemented from its public
specification:

  - per-class / per-threshold AP with 2D center-distance matching at
    {0.5, 1, 2, 4} m, greedy by descending score, one match per GT;
  - precision interpolated onto a 101-point recall grid, AP = normalized
    area above (recall > 10%, precision > 10%);
  - five TP error metrics at the 2 m threshold (ATE translation, ASE scale
    = 1 - aligned-IoU, AOE orientation, AVE velocity, AAE attribute),
    averaged over the recall range via confidence-interpolated cumulative
    means, with the official class exemptions (traffic_cone: no
    vel/orient/attr; barrier: no vel/attr, yaw period pi);
  - class-range ego-distance filtering and the 500-box/sample cap;
  - NDS = (5 * mAP + sum_tp max(0, 1 - mTP)) / 10.

The result dict mirrors what nuscenes_utils.format_nuscene_results
(nuscenes_utils.py:471-500) reads: label_aps, label_tp_errors,
mean_dist_aps, tp_errors, mean_ap, nd_score.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

DETECTION_CLASSES = (
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier")

# detection_cvpr_2019 configuration constants.
DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MAX_BOXES_PER_SAMPLE = 500
MEAN_AP_WEIGHT = 5
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0}
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# Official per-class exemptions: these errors are undefined.
TP_EXEMPT = {
    "traffic_cone": ("vel_err", "orient_err", "attr_err"),
    "barrier": ("vel_err", "attr_err"),
}
_N_REC = 101


@dataclasses.dataclass
class NuscBox:
    """One GT or predicted box in a shared (usually global) frame."""
    translation: np.ndarray           # (3,)
    size: np.ndarray                  # (3,) w, l, h
    yaw: float
    name: str
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, np.float64))
    score: float = -1.0               # predictions only
    attribute: str = ""               # '' on GT means "no attribute"
    ego_dist: float = 0.0             # 2D distance from the ego vehicle
    num_pts: int = -1                 # GT only; -1 = unknown


Frames = Dict[str, List[NuscBox]]     # sample_token -> boxes


def filter_boxes(frames: Frames, is_gt: bool) -> Frames:
    """Class-range + empty-box filtering (devkit filter_eval_boxes)."""
    out: Frames = {}
    for token, boxes in frames.items():
        kept = [b for b in boxes
                if b.name in CLASS_RANGE
                and b.ego_dist < CLASS_RANGE[b.name]
                and not (is_gt and b.num_pts == 0)]
        if not is_gt:
            kept = sorted(kept, key=lambda b: -b.score)[
                :MAX_BOXES_PER_SAMPLE]
        out[token] = kept
    return out


def _center_dist(a: NuscBox, b: NuscBox) -> float:
    return float(np.linalg.norm(
        np.asarray(a.translation[:2]) - np.asarray(b.translation[:2])))


def scale_iou(a: NuscBox, b: NuscBox) -> float:
    """IoU of the two boxes after aligning center and orientation."""
    sa = np.maximum(np.asarray(a.size, np.float64), 0)
    sb = np.maximum(np.asarray(b.size, np.float64), 0)
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa) + np.prod(sb) - inter)
    return inter / union if union > 0 else 0.0


def yaw_diff(a: NuscBox, b: NuscBox, period: float = 2 * np.pi) -> float:
    d = (a.yaw - b.yaw) % period
    return float(min(d, period - d))


def _cummean(x: np.ndarray) -> np.ndarray:
    """NaN-aware cumulative mean (devkit utils.cummean)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    s = np.nancumsum(x.astype(np.float64))
    n = np.cumsum(~np.isnan(x))
    return np.divide(s, n, out=np.zeros_like(s), where=n != 0)


@dataclasses.dataclass
class MetricData:
    """101-point PR + TP-error curves for one (class, threshold)."""
    recall: np.ndarray
    precision: np.ndarray
    confidence: np.ndarray
    trans_err: np.ndarray
    scale_err: np.ndarray
    orient_err: np.ndarray
    vel_err: np.ndarray
    attr_err: np.ndarray

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls) -> "MetricData":
        rec = np.linspace(0, 1, _N_REC)
        z = np.zeros(_N_REC)
        one = np.ones(_N_REC)
        return cls(rec, z, z, one, one, one, one, one)


def accumulate(gt: Frames, pred: Frames, class_name: str,
               dist_th: float) -> Optional[MetricData]:
    """Greedy center-distance matching -> interpolated curves
    (devkit algo.accumulate). Returns None when the class has no GT."""
    npos = sum(1 for boxes in gt.values() for b in boxes
               if b.name == class_name)
    if npos == 0:
        return None

    preds = [(b, tok) for tok, boxes in pred.items() for b in boxes
             if b.name == class_name]
    preds.sort(key=lambda x: -x[0].score)
    if not preds:
        return MetricData.no_predictions()

    period = np.pi if class_name == "barrier" else 2 * np.pi
    taken = set()
    tp, fp, conf = [], [], []
    match = {k: [] for k in TP_METRICS}
    match_conf: List[float] = []
    for box, tok in preds:
        best_d, best_i = np.inf, None
        for i, g in enumerate(gt.get(tok, [])):
            if g.name == class_name and (tok, i) not in taken:
                d = _center_dist(g, box)
                if d < best_d:
                    best_d, best_i = d, i
        if best_d < dist_th:
            taken.add((tok, best_i))
            g = gt[tok][best_i]
            tp.append(1)
            fp.append(0)
            conf.append(box.score)
            match["trans_err"].append(_center_dist(g, box))
            match["scale_err"].append(1.0 - scale_iou(g, box))
            match["orient_err"].append(yaw_diff(g, box, period))
            gv = np.asarray(g.velocity, np.float64)
            pv = np.asarray(box.velocity, np.float64)
            match["vel_err"].append(float(np.linalg.norm(gv - pv)))
            match["attr_err"].append(
                np.nan if g.attribute == ""
                else 1.0 - float(g.attribute == box.attribute))
            match_conf.append(box.score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(box.score)

    if len(match_conf) == 0:
        return MetricData.no_predictions()

    tp_c = np.cumsum(tp).astype(np.float64)
    fp_c = np.cumsum(fp).astype(np.float64)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / npos
    conf = np.asarray(conf, np.float64)

    rec_interp = np.linspace(0, 1, _N_REC)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    curves = {}
    mc = np.asarray(match_conf, np.float64)
    for key in TP_METRICS:
        tmp = _cummean(np.asarray(match[key], np.float64))
        # conf decreases along the match list; np.interp needs ascending x.
        curves[key] = np.interp(conf_i[::-1], mc[::-1], tmp[::-1])[::-1]

    return MetricData(recall=rec_interp, precision=prec_i,
                      confidence=conf_i, **curves)


def calc_ap(md: MetricData) -> float:
    """Normalized area above (recall, precision) > 10% (devkit calc_ap)."""
    prec = np.copy(md.precision)[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def calc_tp(md: MetricData, metric: str) -> float:
    first = round(100 * MIN_RECALL) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(getattr(md, metric)[first:last + 1]))


def evaluate(gt: Frames, pred: Frames,
             class_names: Sequence[str] = DETECTION_CLASSES,
             filter_by_range: bool = True) -> Dict:
    """Full NDS evaluation. Returns the devkit-shaped metrics dict."""
    if filter_by_range:
        gt = filter_boxes(gt, is_gt=True)
        pred = filter_boxes(pred, is_gt=False)

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tp: Dict[str, Dict[str, float]] = {}
    for cls in class_names:
        mds = {th: accumulate(gt, pred, cls, th) for th in DIST_THS}
        if all(m is None for m in mds.values()):
            continue
        label_aps[cls] = {th: (calc_ap(m) if m is not None else 0.0)
                          for th, m in mds.items()}
        md_tp = mds[DIST_TH_TP]
        errs = {}
        for metric in TP_METRICS:
            if metric in TP_EXEMPT.get(cls, ()):
                errs[metric] = np.nan
            elif md_tp is None:
                errs[metric] = 1.0
            else:
                errs[metric] = calc_tp(md_tp, metric)
        label_tp[cls] = errs

    mean_dist_aps = {cls: float(np.mean(list(aps.values())))
                     for cls, aps in label_aps.items()}
    mean_ap = (float(np.mean(list(mean_dist_aps.values())))
               if mean_dist_aps else 0.0)
    tp_errors = {}
    for metric in TP_METRICS:
        vals = [label_tp[c][metric] for c in label_tp]
        tp_errors[metric] = (float(np.nanmean(vals))
                             if vals and not np.all(np.isnan(vals)) else 1.0)
    tp_scores = {k: max(0.0, 1.0 - v) for k, v in tp_errors.items()}
    nds = ((MEAN_AP_WEIGHT * mean_ap + sum(tp_scores.values()))
           / (MEAN_AP_WEIGHT + len(TP_METRICS)))
    return {"label_aps": label_aps, "label_tp_errors": label_tp,
            "mean_dist_aps": mean_dist_aps, "tp_errors": tp_errors,
            "mean_ap": mean_ap, "nd_score": nds}


def format_results(metrics: Dict,
                   class_names: Sequence[str] = DETECTION_CLASSES) -> str:
    """Human-readable summary (nuscenes_utils.format_nuscene_results)."""
    lines = []
    for name in class_names:
        if name not in metrics["label_aps"]:
            continue
        aps = metrics["label_aps"][name]
        errs = metrics["label_tp_errors"][name]
        lines.append(
            f"{name}: AP@" + ", ".join(f"{t}m={a * 100:.2f}"
                                       for t, a in aps.items())
            + " | " + ", ".join(f"{k}={v:.3f}" for k, v in errs.items())
            + f" | mean AP: {metrics['mean_dist_aps'][name]:.4f}")
    for key, val in metrics["tp_errors"].items():
        lines.append(f"{key}:\t{val:.4f}")
    lines.append(f"mAP:\t{metrics['mean_ap']:.4f}")
    lines.append(f"NDS:\t{metrics['nd_score']:.4f}")
    return "\n".join(lines)
