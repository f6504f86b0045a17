"""Detection post-processing: NMS selection and recall records
(detection/post.py; pcdet model_nms_utils and Detector3DTemplate's
post_processing / generate_recall_record).

Every output is fixed-shape: a selection is a padded (K,) set with a
validity mask, score thresholding folds into the mask. The NMS cores are
ops/boxes3d.py's ``nms_bev``, ``nms_normal_bev`` and ``circle_nms``; each
call opens the program span ``proposals.nms`` (utils/profiling.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops import boxes3d
from ..utils.profiling import span
from .dense_heads import top_k_stable


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    # nms_bev | nms_normal_bev | circle_nms. For circle_nms, nms_thresh is
    # the SQUARED-center-distance threshold (the reference's min_radius)
    nms_type: str = "nms_bev"
    nms_thresh: float = 0.7
    nms_pre_maxsize: int = 1024
    nms_post_maxsize: int = 256
    multi_classes_nms: bool = False
    score_thresh: float = 0.1
    output_raw_score: bool = False
    recall_thresh_list: Tuple[float, ...] = (0.3, 0.5, 0.7)


def _nms_fn(name: str):
    return {"nms_bev": boxes3d.nms_bev,
            "nms_normal_bev": boxes3d.nms_normal_bev,
            "circle_nms": boxes3d.circle_nms}[name]


def class_agnostic_nms(scores: torch.Tensor, boxes: torch.Tensor,
                       cfg: NMSConfig,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One item: (N,) scores, (N, 7) boxes -> the top nms_post_maxsize
    survivors (sel_idx (K,), sel_scores (K,), sel_valid (K,)), by
    descending score."""
    n = scores.shape[0]
    ok = scores >= cfg.score_thresh
    if valid is not None:
        ok = ok & valid
    masked = torch.where(ok, scores, torch.full_like(scores, float("-inf")))
    k_pre = min(cfg.nms_pre_maxsize, n)
    top_scores, top_idx = top_k_stable(masked, k_pre)
    with span("proposals.nms"):
        keep = _nms_fn(cfg.nms_type)(boxes[top_idx], top_scores,
                                     cfg.nms_thresh,
                                     valid=torch.isfinite(top_scores))
    kept = torch.where(keep, top_scores,
                       torch.full_like(top_scores, float("-inf")))
    sel_scores, sel_of_top = top_k_stable(kept, min(cfg.nms_post_maxsize,
                                                    k_pre))
    sel_valid = torch.isfinite(sel_scores)
    return (top_idx[sel_of_top],
            torch.where(sel_valid, sel_scores, torch.zeros_like(sel_scores)),
            sel_valid)


def multi_classes_nms(cls_scores: torch.Tensor, boxes: torch.Tensor,
                      cfg: NMSConfig,
                      valid: Optional[torch.Tensor] = None):
    """Per-class NMS, one item: cls_scores (N, C) normalised -> (boxes
    (C*K, 7), scores, labels 1-based, valid)."""
    outs = []
    for k in range(cls_scores.shape[1]):
        idx, sc, v = class_agnostic_nms(cls_scores[:, k], boxes, cfg, valid)
        outs.append((boxes[idx], sc, torch.full_like(idx, k + 1,
                                                     dtype=torch.int32), v))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(4))


def post_processing(batch_cls_preds: torch.Tensor,
                    batch_box_preds: torch.Tensor, cfg: NMSConfig,
                    cls_preds_normalized: bool = False,
                    valid: Optional[torch.Tensor] = None,
                    labels: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Batched final-box selection (detector3d_template.py:178-284).

    batch_cls_preds (B, N, num_class) logits (probabilities when
    ``cls_preds_normalized``), batch_box_preds (B, N, 7+); ``labels`` (B, N)
    1-based overrides the argmax class (two-stage heads, whose score is
    class-agnostic). Returns padded {"boxes" (B, K, 7), "scores", "labels",
    "valid"}."""
    cls = batch_cls_preds if cls_preds_normalized \
        else torch.sigmoid(batch_cls_preds)
    if labels is None:
        labels = cls.argmax(-1).to(torch.int32) + 1
    if valid is None:
        valid = torch.ones(cls.shape[:2], dtype=torch.bool, device=cls.device)
    outs = []
    for c, raw_c, b, v, lb in zip(cls, batch_cls_preds,
                                  batch_box_preds[..., :7], valid, labels):
        if cfg.multi_classes_nms:
            outs.append(multi_classes_nms(c, b, cfg, v))
            continue
        idx, sc, vd = class_agnostic_nms(c.max(-1).values, b, cfg, v)
        if cfg.output_raw_score:
            sc = raw_c.max(-1).values[idx] * vd.to(c.dtype)
        outs.append((b[idx], sc, lb[idx], vd))
    bx, sc, lb, vd = (torch.stack([o[i] for o in outs]) for i in range(4))
    return {"boxes": bx, "scores": sc, "labels": lb * vd.to(torch.int32),
            "valid": vd}


def generate_recall_record(pred_boxes: torch.Tensor, pred_valid: torch.Tensor,
                           gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                           thresh_list: Tuple[float, ...] = (0.3, 0.5, 0.7),
                           rois: Optional[torch.Tensor] = None,
                           roi_valid: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
    """Recall counters against the GT, one item
    (detector3d_template.generate_recall_record): {"gt": count,
    "rcnn_<t>": recalled, "roi_<t>": recalled}."""
    def best(boxes, v):
        iou = boxes3d.boxes_iou3d(boxes[:, :7], gt_boxes[:, :7])
        iou = torch.where(v[:, None] & gt_valid[None, :], iou,
                          torch.zeros_like(iou))
        return iou.max(dim=0).values

    out = {"gt": gt_valid.sum()}
    b = best(pred_boxes, pred_valid)
    for t in thresh_list:
        out[f"rcnn_{t}"] = ((b > t) & gt_valid).sum()
    if rois is not None:
        rv = roi_valid if roi_valid is not None else torch.ones(
            rois.shape[:1], dtype=torch.bool, device=rois.device)
        rb = best(rois, rv)
        for t in thresh_list:
            out[f"roi_{t}"] = ((rb > t) & gt_valid).sum()
    return out
