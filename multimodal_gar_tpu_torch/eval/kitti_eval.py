"""KITTI object-detection AP evaluation (R40), host-side numpy.

Capability parity with the reference's vendored KITTI eval suite
(pcdet/datasets/kitti/kitti_object_eval_python/eval.py, 808 LoC numba;
SURVEY.md §2.2 row 19), re-implemented from the published KITTI protocol:

  - three metrics: 2D bbox (image), BEV (rotated), 3D (rotated) IoU;
  - three difficulties with min-height / truncation / occlusion gating
    (difficulty lives on the GT objects, data/kitti.py:KittiObject);
  - class-specific min overlaps (Car 0.7, Ped/Cyc 0.5);
  - "similar" classes (Van~Car, Person_sitting~Pedestrian) and DontCare
    regions count as ignored — they neither score nor penalize;
  - R40 interpolated AP: mean precision at recall 1/40 .. 40/40, with score
    thresholds taken from the sorted TP scores at those recall fractions;
  - AOS (average orientation similarity, bbox metric only): each TP
    contributes (1 + cos(gt_alpha - det_alpha)) / 2 and each FP contributes
    0; the per-threshold similarity is normalized by (tp + fp) and
    interpolated/averaged exactly like precision (reference
    kitti_object_eval_python/eval.py:168,237-263).

The greedy per-image assignment mirrors the devkit: each valid GT takes the
highest-overlap unassigned detection above min_overlap; detections matched
to ignored GTs or DontCare areas are neither TP nor FP.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

MIN_OVERLAPS = {"Car": 0.7, "Van": 0.7, "Truck": 0.7,
                "Pedestrian": 0.5, "Person_sitting": 0.5, "Cyclist": 0.5}
SIMILAR = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}
N_SAMPLE_PTS = 41


def bbox_iou_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) image-plane IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


def bbox_inter_over_det(gt: np.ndarray, det: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) intersection / DETECTION area — the devkit's
    ``boxoverlap(det, dontcare, criterion=0)`` used by the DontCare
    stuff-area pass (bbox metric only)."""
    if len(gt) == 0 or len(det) == 0:
        return np.zeros((len(gt), len(det)), np.float32)
    x1 = np.maximum(gt[:, None, 0], det[None, :, 0])
    y1 = np.maximum(gt[:, None, 1], det[None, :, 1])
    x2 = np.minimum(gt[:, None, 2], det[None, :, 2])
    y2 = np.minimum(gt[:, None, 3], det[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    det_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    return inter / np.maximum(det_area[None, :], 1e-9)


def _rect_corners(box: np.ndarray) -> np.ndarray:
    """(7,) lidar box -> (4, 2) BEV corners."""
    dx, dy = box[3] / 2, box[4] / 2
    # counter-clockwise winding (the Sutherland-Hodgman inside test requires it)
    corners = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]])
    c, s = np.cos(box[6]), np.sin(box[6])
    rot = np.array([[c, -s], [s, c]])
    return corners @ rot.T + box[:2]


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def _polygon_clip(subject: np.ndarray, clip: np.ndarray) -> float:
    """Area of intersection of two convex polygons (Sutherland-Hodgman).
    Both polygons must be wound counter-clockwise."""
    poly = list(subject)
    for i in range(len(clip)):
        p1, p2 = clip[i], clip[(i + 1) % len(clip)]
        if not poly:
            return 0.0
        edge = p2 - p1
        new_poly = []
        prev = poly[-1]
        prev_in = _cross2(edge, prev - p1) >= 0
        for cur in poly:
            cur_in = _cross2(edge, cur - p1) >= 0
            if cur_in != prev_in:
                d = cur - prev
                denom = _cross2(edge, d)
                t = _cross2(edge, p1 - prev) / denom if abs(denom) > 1e-12 \
                    else 0.0
                new_poly.append(prev + t * d)
            if cur_in:
                new_poly.append(cur)
            prev, prev_in = cur, cur_in
        poly = new_poly
    if len(poly) < 3:
        return 0.0
    pts = np.asarray(poly)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def bev_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) rotated BEV IoU (lidar boxes)."""
    out = np.zeros((len(a), len(b)), np.float32)
    ca = [_rect_corners(x) for x in a]
    cb = [_rect_corners(x) for x in b]
    for i in range(len(a)):
        for j in range(len(b)):
            inter = _polygon_clip(ca[i], cb[j])
            union = a[i, 3] * a[i, 4] + b[j, 3] * b[j, 4] - inter
            out[i, j] = inter / max(union, 1e-9)
    return out


def iou_3d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) rotated 3D IoU (lidar boxes, z = center)."""
    out = np.zeros((len(a), len(b)), np.float32)
    ca = [_rect_corners(x) for x in a]
    cb = [_rect_corners(x) for x in b]
    for i in range(len(a)):
        for j in range(len(b)):
            inter_bev = _polygon_clip(ca[i], cb[j])
            za1, za2 = a[i, 2] - a[i, 5] / 2, a[i, 2] + a[i, 5] / 2
            zb1, zb2 = b[j, 2] - b[j, 5] / 2, b[j, 2] + b[j, 5] / 2
            zo = max(0.0, min(za2, zb2) - max(za1, zb1))
            inter = inter_bev * zo
            union = a[i, 3] * a[i, 4] * a[i, 5] \
                + b[j, 3] * b[j, 4] * b[j, 5] - inter
            out[i, j] = inter / max(union, 1e-9)
    return out


@dataclasses.dataclass
class FrameAnnotations:
    """One frame's GT + detections for one class evaluation."""
    gt_boxes: np.ndarray          # (G, 7) lidar or (G, 4) bbox metric
    gt_names: List[str]
    gt_difficulty: np.ndarray     # (G,) int (-1 = unusable)
    det_boxes: np.ndarray         # (D, 7|4)
    det_names: List[str]
    det_scores: np.ndarray        # (D,)
    # devkit ignored_det==1 (clean_data: 2D bbox height < MIN_HEIGHT for
    # the difficulty): such detections may be consumed by GTs but are
    # never scored and never count as false positives. Optional because
    # lidar-native pipelines carry no 2D boxes for 3D detections.
    det_ignored: np.ndarray = None
    # observation angles (KITTI label alpha) for AOS; optional — AOS is
    # only defined for the bbox metric on camera-frame labels
    gt_alphas: np.ndarray = None      # (G,)
    det_alphas: np.ndarray = None     # (D,)

    def __post_init__(self):
        if self.det_ignored is None:
            self.det_ignored = np.zeros(len(self.det_names), bool)

    @property
    def has_alphas(self) -> bool:
        return self.gt_alphas is not None and self.det_alphas is not None


def _classify(frame: FrameAnnotations, cls: str, difficulty: int):
    """-> (gt_care (G,), gt_ignored (G,), det_care (D,)) per devkit
    clean_data: care = scored; ignored = overlaps allowed but not scored."""
    care_g, ign_g = [], []
    for name, diff in zip(frame.gt_names, frame.gt_difficulty):
        if name == cls and 0 <= diff <= difficulty:
            care_g.append(True)
            ign_g.append(False)
        elif name == cls or name in SIMILAR.get(cls, ()):
            # DontCare is NOT in this ignored set: the devkit keeps DontCare
            # regions out of GT-det assignment entirely and handles them only
            # via the bbox-metric stuff-area pass below.
            care_g.append(False)
            ign_g.append(True)
        else:
            care_g.append(False)
            ign_g.append(False)
    det_care = np.asarray([n == cls for n in frame.det_names], bool)
    return np.asarray(care_g, bool), np.asarray(ign_g, bool), det_care


def _frame_stats(iou: np.ndarray, scores: np.ndarray, care_g, ign_g,
                 det_care, min_overlap: float, thresh: float,
                 det_ignored=None, dc_overlap=None,
                 gt_alphas=None, det_alphas=None):
    """Matching at one score threshold -> (tp, fp, fn, similarity).

    Mirrors the devkit's compute_statistics with compute_fp=True
    (kitti_object_eval_python/eval.py compute_statistics_jit): GTs iterate
    in order; each (care or ignored) GT claims its max-OVERLAP unassigned
    detection with overlap strictly > min_overlap; ignored GTs consume
    their match without scoring; unmatched above-threshold detections are
    false positives. With alphas given, each TP adds
    (1 + cos(gt_alpha - det_alpha)) / 2 to the orientation similarity
    (each FP implicitly adds 0 — the devkit's tmp array of fp zeros,
    eval.py:263-268)."""
    g, d = iou.shape
    thresh_ok = scores >= thresh      # devkit ignored_threshold
    det_ign = det_ignored if det_ignored is not None \
        else np.zeros(d, bool)
    assigned = np.zeros(d, bool)
    tp = fn = 0
    sim = 0.0
    aos = gt_alphas is not None and det_alphas is not None
    for i in range(g):
        if not care_g[i] and not ign_g[i]:
            continue
        det_idx, max_ov, on_ignored = -1, 0.0, False
        for j in range(d):
            if not det_care[j] or assigned[j] or not thresh_ok[j]:
                continue
            ov = iou[i, j]
            if ov > min_overlap and (ov > max_ov or on_ignored) \
                    and not det_ign[j]:
                max_ov, det_idx, on_ignored = ov, j, False
            elif ov > min_overlap and det_idx < 0 and det_ign[j]:
                det_idx, on_ignored = j, True    # fallback: ignored det
        if det_idx < 0:
            if care_g[i]:
                fn += 1
        elif ign_g[i] or det_ign[det_idx]:
            assigned[det_idx] = True          # consumed, not scored
        else:
            assigned[det_idx] = True
            tp += 1
            if aos:
                sim += (1.0 + np.cos(gt_alphas[i]
                                     - det_alphas[det_idx])) / 2.0
    det_ign = det_ignored if det_ignored is not None \
        else np.zeros(d, bool)
    # DontCare absorb-all (devkit stuff pass, bbox metric ONLY): every
    # unassigned detection whose intersection/det-area with ANY DontCare
    # region exceeds min_overlap escapes the FP count. ``dc_overlap`` is
    # that (n_dontcare, D) criterion matrix — None for bev/3d metrics,
    # where the devkit runs no stuff pass (DontCare has no 3D box).
    dc_hit = np.zeros(d, bool)
    if dc_overlap is not None and dc_overlap.size:
        for j in range(d):
            if det_care[j] and thresh_ok[j] and not assigned[j]:
                if (dc_overlap[:, j] > min_overlap).any():
                    dc_hit[j] = True
    fp = int((det_care & thresh_ok & ~assigned & ~det_ign & ~dc_hit).sum())
    return tp, fp, fn, sim


def _tp_scores(iou, scores, care_g, ign_g, det_care, min_overlap,
               det_ignored=None):
    """Scores of detections matched to care GTs (devkit compute_statistics
    with compute_fp=False) — drives threshold selection. In this stage each
    GT claims its max-SCORE detection above min_overlap (strict >), not
    the max-overlap one; ignored GTs consume without emitting."""
    g, d = iou.shape
    assigned = np.zeros(d, bool)
    out = []
    for i in range(g):
        if not care_g[i] and not ign_g[i]:
            continue
        det_idx, best_score = -1, -np.inf
        for j in range(d):
            if not det_care[j] or assigned[j]:
                continue
            if iou[i, j] > min_overlap and scores[j] > best_score:
                best_score, det_idx = scores[j], j
        if det_idx >= 0:
            assigned[det_idx] = True
            if care_g[i] and not (det_ignored is not None
                                  and det_ignored[det_idx]):
                out.append(scores[det_idx])
    return out


def _iou_for(frames: Sequence[FrameAnnotations], metric: str):
    fn = {"bbox": bbox_iou_2d, "bev": lambda a, b: bev_iou(a, b),
          "3d": iou_3d}[metric]
    return [fn(f.gt_boxes, f.det_boxes) for f in frames]


def eval_class(frames: Sequence[FrameAnnotations], cls: str,
               difficulty: int, metric: str,
               min_overlap: Optional[float] = None) -> Dict[str, float]:
    """AP_R40 (and, for the bbox metric with alphas, AOS_R40) for one
    (class, difficulty, metric)."""
    mo = min_overlap if min_overlap is not None else MIN_OVERLAPS[cls]
    # AOS is defined on the image-plane matching only (devkit: compute_aos
    # implies metric == 0), and needs observation angles on both sides
    compute_aos = metric == "bbox" and all(f.has_alphas for f in frames)
    ious = _iou_for(frames, metric)
    parts = [_classify(f, cls, difficulty) for f in frames]
    # devkit stuff pass exists only for the 2D bbox metric, with
    # intersection/det-area as the criterion (boxoverlap criterion 0)
    dc_overlaps = []
    for f in frames:
        if metric == "bbox":
            dc_rows = np.asarray([n == "DontCare" for n in f.gt_names], bool)
            dc_overlaps.append(bbox_inter_over_det(
                f.gt_boxes[dc_rows], f.det_boxes))
        else:
            dc_overlaps.append(None)
    total_gt = sum(int(c.sum()) for c, _, _ in parts)
    if total_gt == 0:
        out = {"ap": 0.0, "precision": np.zeros(N_SAMPLE_PTS),
               "recall": np.zeros(N_SAMPLE_PTS)}
        if compute_aos:
            out["aos"] = 0.0
        return out

    all_tp_scores = []
    for f, iou, (care_g, ign_g, det_care) in zip(frames, ious, parts):
        all_tp_scores += _tp_scores(iou, f.det_scores, care_g, ign_g,
                                    det_care, mo,
                                    det_ignored=f.det_ignored)
    # devkit get_thresholds: score at each crossed recall step
    all_tp_scores = np.sort(all_tp_scores)[::-1]
    thresholds = []
    cur_recall = 0.0
    for i, s in enumerate(all_tp_scores):
        l_rec = (i + 1) / total_gt
        r_rec = (i + 2) / total_gt if i < len(all_tp_scores) - 1 else l_rec
        if (r_rec - cur_recall) < (cur_recall - l_rec) \
                and i < len(all_tp_scores) - 1:
            continue
        thresholds.append(s)
        cur_recall += 1.0 / (N_SAMPLE_PTS - 1)
    prec = np.zeros(N_SAMPLE_PTS)
    rec = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    for k, t in enumerate(thresholds):
        tp = fp = fn = 0
        sim = 0.0
        for f, iou, dc_ov, (care_g, ign_g, det_care) in zip(
                frames, ious, dc_overlaps, parts):
            a, b, c, s = _frame_stats(
                iou, f.det_scores, care_g, ign_g, det_care, mo, t,
                det_ignored=f.det_ignored, dc_overlap=dc_ov,
                gt_alphas=f.gt_alphas if compute_aos else None,
                det_alphas=f.det_alphas if compute_aos else None)
            tp, fp, fn, sim = tp + a, fp + b, fn + c, sim + s
        prec[k] = tp / max(tp + fp, 1)
        rec[k] = tp / max(tp + fn, 1)
        if compute_aos:
            # devkit eval.py:237-263: aos = similarity / (tp + fp)
            aos[k] = sim / max(tp + fp, 1)
    # right-max interpolation then R40 mean (skip the recall-0 point)
    for k in range(N_SAMPLE_PTS - 2, -1, -1):
        prec[k] = max(prec[k], prec[k + 1])
        aos[k] = max(aos[k], aos[k + 1])
    ap = float(prec[1:].sum() / (N_SAMPLE_PTS - 1))
    out = {"ap": ap * 100.0, "precision": prec, "recall": rec}
    if compute_aos:
        out["aos"] = float(aos[1:].sum() / (N_SAMPLE_PTS - 1)) * 100.0
        out["orientation_similarity"] = aos
    return out


def evaluate(frames: Sequence[FrameAnnotations],
             classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
             metrics: Sequence[str] = ("bev", "3d"),
             difficulties: Sequence[int] = (0, 1, 2)) -> Dict[str, float]:
    """Full result table {"<cls>_<metric>_<difficulty>": AP_R40}; for the
    bbox metric with observation angles present, also
    {"<cls>_aos_<difficulty>": AOS_R40}."""
    out = {}
    for cls in classes:
        for metric in metrics:
            for d in difficulties:
                diff = ['easy', 'moderate', 'hard'][d]
                r = eval_class(frames, cls, d, metric)
                out[f"{cls}_{metric}_{diff}"] = r["ap"]
                if "aos" in r:
                    out[f"{cls}_aos_{diff}"] = r["aos"]
    return out
