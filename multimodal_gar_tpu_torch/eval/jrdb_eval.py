"""JRDB-Act evaluation: tasks 1 (action), 3 (social grouping), 4 (activity).

Capability parity with the external jrdb_toolkit evaluation chain the
reference drives per epoch (train_func.py:284-315): ``constrct_group`` (run
the model over the val set, write result files) -> ``JRDB_eval.evaluate`` ->
``analysis_result`` (G1..G5/overall AP, action AP, activity AP). The toolkit
is not vendored in the reference (jrdb_toolkit/ is empty); this module
re-implements the protocol from the public JRDB-Act specification on top of
eval/ap.py, reading/writing the same AVA-style CSV result format so outputs
remain interchangeable.

CSV line format (one box-label detection per line):
  image_key,x1,y1,x2,y2,label_id,score[,group_id]
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .ap import detection_ap, set_detection_ap

# group-size buckets for task 3: G1, G2, G3, G4, G5+ (BASELINE.md)
GROUP_SIZE_BUCKETS = (1, 2, 3, 4, 5)


# ---------------------------------------------------------------------------
# record containers
# ---------------------------------------------------------------------------

def _key(seq_id: int, frame_id: int) -> str:
    return f"{int(seq_id):04d}:{int(frame_id):06d}"


class ResultAccumulator:
    """Collects per-frame GT + predictions across an eval epoch."""

    def __init__(self):
        # action/activity: label -> [(key, box, score)] / [(key, box)]
        self.det_action = defaultdict(list)
        self.gt_action = defaultdict(list)
        self.det_activity = defaultdict(list)
        self.gt_activity = defaultdict(list)
        # grouping: [(key, boxes, score)] / [(key, boxes)]
        self.det_groups: List[Tuple] = []
        self.gt_groups: List[Tuple] = []

    # -- per-frame ingestion -------------------------------------------------
    def add_frame(self, seq_id: int, frame_id: int,
                  boxes: np.ndarray, valid: np.ndarray,
                  gt_actions: np.ndarray, gt_activity: np.ndarray,
                  gt_group_id: np.ndarray,
                  pred_action_scores: np.ndarray,
                  pred_activity_scores: np.ndarray,
                  pred_group_ids: np.ndarray,
                  group_scores: Optional[np.ndarray] = None) -> None:
        """
        Args:
          boxes: (N, 4) xyxy; valid: (N,) bool.
          gt_actions / gt_activity: (N, 27) multi-hot.
          pred_*_scores: (N, 27) per-class confidences.
          gt_group_id / pred_group_ids: (N,) ints.
          group_scores: optional per-person group confidence (N,).
        """
        key = _key(seq_id, frame_id)
        idx = np.where(valid)[0]
        for i in idx:
            b = boxes[i]
            for c in np.where(gt_actions[i] > 0)[0]:
                self.gt_action[int(c)].append((key, b))
            for c in np.where(gt_activity[i] > 0)[0]:
                self.gt_activity[int(c)].append((key, b))
            for c in range(pred_action_scores.shape[1]):
                self.det_action[int(c)].append(
                    (key, b, float(pred_action_scores[i, c])))
            for c in range(pred_activity_scores.shape[1]):
                self.det_activity[int(c)].append(
                    (key, b, float(pred_activity_scores[i, c])))

        for gid in np.unique(gt_group_id[idx]):
            members = idx[gt_group_id[idx] == gid]
            self.gt_groups.append((key, boxes[members]))
        for gid in np.unique(pred_group_ids[idx]):
            members = idx[pred_group_ids[idx] == gid]
            score = float(np.mean(group_scores[members])) \
                if group_scores is not None else 1.0
            self.det_groups.append((key, boxes[members], score))

    # -- metric computation --------------------------------------------------
    def evaluate_actions(self, which: str = "action") -> Dict[str, float]:
        det = self.det_action if which == "action" else self.det_activity
        gt = self.gt_action if which == "action" else self.gt_activity
        aps = {}
        for c, gts in gt.items():
            ap = detection_ap(det.get(c, []), gts)
            if not np.isnan(ap):
                aps[c] = ap
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        return {"mAP": mean_ap, "per_class": aps}

    def evaluate_grouping(self) -> Dict[str, float]:
        """Task 3: AP bucketed by GT group size (G1..G5+) + overall mean."""
        res = {}
        buckets = []
        for k, size in enumerate(GROUP_SIZE_BUCKETS):
            last = (k == len(GROUP_SIZE_BUCKETS) - 1)

            def in_bucket(n):
                return n >= size if last else n == size

            gt_b = [(key, b) for key, b in self.gt_groups if in_bucket(len(b))]
            det_b = [(key, b, s) for key, b, s in self.det_groups
                     if in_bucket(len(b))]
            ap = set_detection_ap(det_b, gt_b) if gt_b else float("nan")
            res[f"G{size}_AP"] = 0.0 if np.isnan(ap) else float(ap)
            if not np.isnan(ap):
                buckets.append(ap)
        res["overall_AP"] = float(np.mean(buckets)) if buckets else 0.0
        return res

    def evaluate_all(self) -> Dict[str, float]:
        out = self.evaluate_grouping()
        out["action_AP"] = self.evaluate_actions("action")["mAP"]
        out["activity_AP"] = self.evaluate_actions("activity")["mAP"]
        return out


# ---------------------------------------------------------------------------
# result-file IO — AVA ActivityNet CSV convention
#
# The jrdb_toolkit evaluator the reference drives (train_func.py:289-315) is
# AVA-derived: it consumes CSV files whose rows are
#   video_id,timestamp,x1,y1,x2,y2,label_id[,score]
# (score column present for detections, absent for ground truth). For task_3
# the label_id column carries the per-frame GROUP id (constrct_group output);
# for tasks 1/4 it carries the action/activity class id. Box coordinates are
# written in pixels (the toolkit accepts any consistent unit since matching
# is IoU-based).
# ---------------------------------------------------------------------------

def write_detection_csv(path: str, records: Iterable[Tuple]) -> None:
    """records: (video_id, timestamp, box(4,), label_id, score)"""
    with open(path, "w") as f:
        for vid, ts, b, label, score in records:
            f.write(f"{vid},{int(ts)},{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},"
                    f"{b[3]:.3f},{int(label)},{score:.6f}\n")


def write_gt_csv(path: str, records: Iterable[Tuple]) -> None:
    """records: (video_id, timestamp, box(4,), label_id)"""
    with open(path, "w") as f:
        for vid, ts, b, label in records:
            f.write(f"{vid},{int(ts)},{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},"
                    f"{b[3]:.3f},{int(label)}\n")


def read_csv(path: str) -> List[Tuple]:
    """Parse an AVA-style CSV. Returns (video_id, timestamp, box(4,),
    label_id, score) tuples; score is None for ground-truth rows."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 7:
                continue
            vid, ts = parts[0], int(parts[1])
            box = np.asarray([float(v) for v in parts[2:6]])
            label = int(parts[6])
            score = float(parts[7]) if len(parts) > 7 else None
            out.append((vid, ts, box, label, score))
    return out


def _groups_from_rows(rows: Sequence[Tuple], with_score: bool) -> List[Tuple]:
    """Reassemble group sets from per-member rows keyed by
    (video, timestamp, group_id)."""
    by_group: Dict = defaultdict(list)
    for vid, ts, box, gid, score in rows:
        by_group[(vid, ts, gid)].append((box, score))
    out = []
    for (vid, ts, _gid), members in by_group.items():
        key = f"{vid}:{ts:06d}"
        boxes = np.stack([m[0] for m in members])
        if with_score:
            out.append((key, boxes,
                        float(np.mean([m[1] for m in members]))))
        else:
            out.append((key, boxes))
    return out


def evaluate_result_files(grouping_det: str, grouping_gt: str,
                          action_det: str, action_gt: str,
                          activity_det: str, activity_gt: str
                          ) -> Dict[str, float]:
    """File-driven evaluation — the toolkit's ``evaluate(labelmap,
    groundtruth, detections, task)`` contract (train_func.py:289-315):
    consumes the six result/GT CSVs and returns the same metrics dict as
    ``ResultAccumulator.evaluate_all``."""
    acc = ResultAccumulator()
    acc.det_groups = _groups_from_rows(read_csv(grouping_det), True)
    acc.gt_groups = _groups_from_rows(read_csv(grouping_gt), False)
    for vid, ts, box, label, score in read_csv(action_det):
        acc.det_action[label].append((f"{vid}:{ts:06d}", box, score))
    for vid, ts, box, label, _ in read_csv(action_gt):
        acc.gt_action[label].append((f"{vid}:{ts:06d}", box))
    for vid, ts, box, label, score in read_csv(activity_det):
        acc.det_activity[label].append((f"{vid}:{ts:06d}", box, score))
    for vid, ts, box, label, _ in read_csv(activity_gt):
        acc.gt_activity[label].append((f"{vid}:{ts:06d}", box))
    return acc.evaluate_all()
