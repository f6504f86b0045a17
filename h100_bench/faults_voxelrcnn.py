"""Faults planted underneath a Voxel R-CNN cell's timed path, to show that
the comparison catches them: each is a context manager that patches the
program for as long as it is open, built as faults.py's are.

- ``nms_thresh_07``: the proposal NMS suppresses at IoU 0.7, not 0.8.
- ``nms_pre_512``: the proposal NMS takes as many boxes as it keeps (the
  top 512 at the cell's sizes, ``nms_post_maxsize``), not 9000.
- ``adamw_not_onecycle``: the step's optimizer is the zoo's default AdamW
  (3e-3, betas 0.9 / 0.999), not the configuration's one-cycle Adam.

Used by tests/test_h100bench_voxelrcnn.py at tiny sizes on the CPU, and on
the card by ``calibrate.readings`` inside a fault's context (PERF.md gives
the command).
"""
from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def nms_thresh_07():
    from multimodal_gar_tpu_torch.ops import boxes3d
    real = boxes3d.nms_bev

    def lower(boxes, scores, iou_threshold=0.7, valid=None):
        return real(boxes, scores, 0.7, valid)
    return _patched(boxes3d, "nms_bev", lower)


def nms_pre_512():
    from multimodal_gar_tpu_torch.detection import roi_heads
    real = roi_heads.class_agnostic_nms

    def fewer(scores, boxes, cfg, valid=None):
        return real(scores, boxes, dataclasses.replace(
            cfg, nms_pre_maxsize=cfg.nms_post_maxsize), valid)
    return _patched(roi_heads, "class_agnostic_nms", fewer)


def adamw_not_onecycle():
    from multimodal_gar_tpu_torch.detection import train
    real = train.create_det_train_state

    def adamw(model, learning_rate=3e-3, weight_decay=0.01, clip_norm=10.0,
              optimizer="adamw", one_cycle=None):
        return real(model, weight_decay=weight_decay, clip_norm=clip_norm)
    return _patched(train, "create_det_train_state", adamw)


FAULTS = {"nms_thresh_07": nms_thresh_07, "nms_pre_512": nms_pre_512,
          "adamw_not_onecycle": adamw_not_onecycle}
