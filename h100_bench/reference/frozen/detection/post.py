"""Class-agnostic NMS selection (detection/post.py; pcdet model_nms_utils),
fixed-shape: a padded (K,) set with a validity mask."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import boxes3d
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
    if cfg.nms_type != "nms_bev":
        raise NotImplementedError("the reference runs nms_bev only")
    keep = boxes3d.nms_bev(boxes[top_idx], top_scores, cfg.nms_thresh,
                           valid=torch.isfinite(top_scores))
    kept = torch.where(keep, top_scores,
                       torch.full_like(top_scores, float("-inf")))
    sel_scores, sel_of_top = top_k_stable(kept, min(cfg.nms_post_maxsize,
                                                    k_pre))
    sel_valid = torch.isfinite(sel_scores)
    return (top_idx[sel_of_top],
            torch.where(sel_valid, sel_scores, torch.zeros_like(sel_scores)),
            sel_valid)
