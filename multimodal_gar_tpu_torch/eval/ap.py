"""AVA/Pascal-style average precision, numpy.

The reference delegates eval to the external (unvendored) jrdb_toolkit
``JRDB_eval.evaluate`` (train_func.py:36-39, 289-315). This module implements
the underlying AP protocol from the public AVA specification: per class,
detections are ranked by score, greedily matched to ground truth at an IoU
threshold, and AP is the area under the interpolated precision-recall curve.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def interpolated_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP (AVA / Pascal VOC 2010+ protocol)."""
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    # monotone non-increasing precision envelope
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def detection_ap(detections: Sequence[Tuple],
                 groundtruth: Sequence[Tuple],
                 iou_threshold: float = 0.5) -> float:
    """AP for one class of box detections.

    detections: iterable of (image_key, box(4,), score)
    groundtruth: iterable of (image_key, box(4,))
    """
    gt_by_img: Dict = defaultdict(list)
    for key, box in groundtruth:
        gt_by_img[key].append(np.asarray(box, np.float64))
    n_gt = sum(len(v) for v in gt_by_img.values())
    if n_gt == 0:
        return float("nan")

    dets = sorted(detections, key=lambda d: -d[2])
    matched = {k: np.zeros(len(v), bool) for k, v in gt_by_img.items()}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (key, box, _score) in enumerate(dets):
        gts = gt_by_img.get(key)
        if not gts:
            fp[i] = 1
            continue
        ious = box_iou(np.asarray(box, np.float64)[None], np.stack(gts))[0]
        ious = np.where(matched[key], -1.0, ious)
        j = int(np.argmax(ious))
        if ious[j] >= iou_threshold:
            matched[key][j] = True
            tp[i] = 1
        else:
            fp[i] = 1

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    return interpolated_ap(recall, precision)


def set_detection_ap(detections: Sequence[Tuple],
                     groundtruth: Sequence[Tuple],
                     iou_threshold: float = 0.5) -> float:
    """AP where each detection/GT is a SET of boxes (social-group detection).

    detections: (image_key, boxes (K, 4), score)
    groundtruth: (image_key, boxes (K', 4))
    A detection matches a GT group iff the member sets correspond one-to-one
    with per-box IoU >= threshold and |K| == |K'| (exact membership).

    Criterion source: the JRDB-Act social-group detection protocol
    (Ehsanpour et al., "JRDB-Act", CVPR 2022 — group detection AP with
    members matched to GT at IoU 0.5, reported per group-size bucket
    G1..G5+). The reference drives the (unvendored, AVA-derived)
    jrdb_toolkit implementation at train_func.py:289-315; in the MGAR
    setting detections reuse the GT person boxes (voxelrcnn_head.py:92), so
    the per-member IoU matching reduces to exact membership equality, which
    this implementation reproduces and tests/test_eval.py pins with
    hand-computed golden AP fixtures.
    """
    gt_by_img: Dict = defaultdict(list)
    for key, boxes in groundtruth:
        gt_by_img[key].append(np.asarray(boxes, np.float64))
    n_gt = sum(len(v) for v in gt_by_img.values())
    if n_gt == 0:
        return float("nan")

    dets = sorted(detections, key=lambda d: -d[2])
    matched = {k: np.zeros(len(v), bool) for k, v in gt_by_img.items()}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (key, boxes, _score) in enumerate(dets):
        boxes = np.asarray(boxes, np.float64)
        gts = gt_by_img.get(key, [])
        hit = -1
        for j, gt_boxes in enumerate(gts):
            if matched[key][j] or len(gt_boxes) != len(boxes):
                continue
            if _sets_match(boxes, gt_boxes, iou_threshold):
                hit = j
                break
        if hit >= 0:
            matched[key][hit] = True
            tp[i] = 1
        else:
            fp[i] = 1

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    return interpolated_ap(recall, precision)


def _sets_match(a: np.ndarray, b: np.ndarray, thr: float) -> bool:
    """Greedy one-to-one box matching covering both equally-sized sets."""
    iou = box_iou(a, b)
    used = np.zeros(len(b), bool)
    for i in range(len(a)):
        ious = np.where(used, -1.0, iou[i])
        j = int(np.argmax(ious))
        if ious[j] < thr:
            return False
        used[j] = True
    return True
