"""Epoch evaluator: run the model over a val pipeline -> JRDB-Act metrics.

The ``constrct_group`` analogue (reference train_func.py:284-315): decode
groups/actions from model outputs, optionally write toolkit-format result
files, and compute G1..G5/overall grouping AP + action/activity mAP.

Same functions and result files as multimodal_gar_tpu/eval/evaluator.py.
The scoring is numpy; a batch and its outputs come to the host once
(``host_arrays``), not field by field.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from ..types import Batch, ModelOutputs
from .jrdb_eval import ResultAccumulator, write_detection_csv, write_gt_csv

# inverse of train/labels.py partition_action_labels: head slice -> 27-class ids
# (classes 10, 25, 26 are not covered by any head — a reference quirk,
# train_utils.py:189-211 — and receive score 0.)
_HEAD_TO_CLASS = {
    "pose_0": ([0, 1, 2], slice(0, 3)),
    "pose_1": ([3, 4, 5], slice(0, 3)),
    "pose_2": ([6, 7, 8, 9], slice(0, 4)),
    "intr_1": ([11, 12, 13], slice(0, 3)),
    "intr_2": ([14, 15, 16, 17, 18, 19], slice(0, 6)),
    "intr_3": ([20, 21, 22, 23, 24], slice(0, 5)),
}


def scores_to_27(pose, interaction) -> np.ndarray:
    """(3x(N,4), 4x(N,k)) head outputs -> (N, 27) per-class scores."""
    n = pose[0].shape[0]
    out = np.zeros((n, 27), np.float32)
    heads = {"pose_0": pose[0], "pose_1": pose[1], "pose_2": pose[2],
             "intr_1": interaction[1], "intr_2": interaction[2],
             "intr_3": interaction[3]}
    for name, (classes, sl) in _HEAD_TO_CLASS.items():
        out[:, classes] = np.asarray(heads[name])[:, sl]
    return out


def host_arrays(value):
    """``value`` (a tensor or a tuple of them) as numpy arrays on the
    host."""
    if isinstance(value, tuple):
        return tuple(host_arrays(v) for v in value)
    return value.detach().cpu().numpy()


def accumulate_batch(acc: ResultAccumulator, batch: Batch,
                     outputs: ModelOutputs) -> None:
    fields = ("boxes2d", "person_valid", "actions", "social_group_activity",
              "social_group_id", "seq_id", "frame_id")
    bt = {k: host_arrays(getattr(batch, k)) for k in fields}
    out = {k: host_arrays(getattr(outputs, k)) for k in (
        "a_theta", "group_ids", "pose", "interaction", "sg_pose",
        "sg_interaction")}
    a_theta, gids, valid = out["a_theta"], out["group_ids"], \
        bt["person_valid"]
    for i in range(batch.images.shape[0]):
        action_scores = scores_to_27([p[i] for p in out["pose"]],
                                     [p[i] for p in out["interaction"]])
        activity_scores = scores_to_27(
            [p[i] for p in out["sg_pose"]],
            [p[i] for p in out["sg_interaction"]])
        # per-person group confidence: mean adjacency to same-group members
        same = gids[i][:, None] == gids[i][None, :]
        cnt = np.maximum(same.sum(1), 1)
        group_scores = (a_theta[i] * same).sum(1) / cnt
        acc.add_frame(
            int(bt["seq_id"][i]), int(bt["frame_id"][i]), bt["boxes2d"][i],
            valid[i], bt["actions"][i], bt["social_group_activity"][i],
            bt["social_group_id"][i], action_scores, activity_scores,
            gids[i], group_scores)


class _FrameLog:
    """Keeps ``add_frame``'s arguments, to be replayed into a
    ``ResultAccumulator`` once every process's frames are in."""

    def __init__(self):
        self.calls = []

    def add_frame(self, *args) -> None:
        self.calls.append(args)


def evaluate_epoch(eval_step: Callable[[Batch], ModelOutputs],
                   batches: Iterable[Batch],
                   result_dir: Optional[str] = None,
                   shard: Optional[Tuple[int, bool]] = None
                   ) -> Dict[str, float]:
    """Run eval over batches; return grouping/action/activity metrics.

    If ``result_dir`` is given, also writes toolkit-format result files
    (grouping / action / activity CSVs, the constrct_group output contract).

    ``shard`` = (data rank r, contributes): under a mesh, ``batches`` are
    this process's shard, its i-th batch the r-th block of the single
    process's i-th; every process's frames are merged
    (parallel/multihost.py: ``merge_eval_records``, a collective) and
    scored in the single process's order. Processes that share a data rank
    evaluate the same rows, and only one of them ``contributes``.
    """
    acc = ResultAccumulator()
    if shard is None:
        for batch in batches:
            out = eval_step(batch)
            accumulate_batch(acc, batch, out)
    else:
        from ..parallel.multihost import merge_eval_records
        rank, contributes = shard
        records = []
        for i, batch in enumerate(batches):
            log = _FrameLog()
            accumulate_batch(log, batch, eval_step(batch))
            if contributes:
                records.append((i, rank, log.calls))
        for _, _, calls in sorted(merge_eval_records(records),
                                  key=lambda rec: rec[:2]):
            for args in calls:
                acc.add_frame(*args)

    metrics = acc.evaluate_all()

    if result_dir:
        write_result_files(acc, result_dir)
    return metrics


def _vid_ts(key: str):
    vid, ts = key.split(":")
    return vid, int(ts)


def write_result_files(acc: ResultAccumulator, result_dir: str) -> None:
    """Write the six AVA-format CSVs: detections (grouping/action/activity —
    the constrct_group output contract) plus the matching ground-truth files
    (the toolkit's `groundtruth=` inputs, train_func.py:289-315)."""
    os.makedirs(result_dir, exist_ok=True)

    def det_rows(dets_by_label):
        for label, dets in dets_by_label.items():
            for key, b, s in dets:
                yield (*_vid_ts(key), b, label, s)

    def gt_rows(gts_by_label):
        for label, gts in gts_by_label.items():
            for key, b in gts:
                yield (*_vid_ts(key), b, label)

    write_detection_csv(os.path.join(result_dir, "action.txt"),
                        det_rows(acc.det_action))
    write_detection_csv(os.path.join(result_dir, "activity.txt"),
                        det_rows(acc.det_activity))
    write_gt_csv(os.path.join(result_dir, "gt_action.txt"),
                 gt_rows(acc.gt_action))
    write_gt_csv(os.path.join(result_dir, "gt_activity.txt"),
                 gt_rows(acc.gt_activity))

    group_records, gt_group_records = [], []
    for gi, (key, boxes, score) in enumerate(acc.det_groups):
        for b in boxes:
            group_records.append((*_vid_ts(key), b, gi, score))
    for gi, (key, boxes) in enumerate(acc.gt_groups):
        for b in boxes:
            gt_group_records.append((*_vid_ts(key), b, gi))
    write_detection_csv(os.path.join(result_dir, "grouping.txt"),
                        group_records)
    write_gt_csv(os.path.join(result_dir, "gt_grouping.txt"),
                 gt_group_records)
