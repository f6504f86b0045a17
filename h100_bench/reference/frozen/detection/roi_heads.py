"""The RoI head's proposals, sampler, targets, losses and decoding
(detection/roi_heads.py; pcdet roi_head_template.py and
proposal_target_layer.py). The sampler draws from an explicit generator,
reseeded per step by the train step as the port's is."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..ops import boxes3d
from ..ops.geometry import rotate_points_along_z
from . import loss_lib
from .box_coders import ResidualCoder
from .post import NMSConfig, class_agnostic_nms


@dataclasses.dataclass(frozen=True)
class RoISamplerConfig:
    """TARGET_CONFIG of the RoI heads."""
    roi_per_image: int = 128
    fg_ratio: float = 0.5
    sample_roi_by_each_class: bool = True
    cls_score_type: str = "roi_iou"      # cls | roi_iou
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    cls_bg_thresh_lo: float = 0.1
    hard_bg_ratio: float = 0.8
    reg_fg_thresh: float = 0.55


def proposal_layer(batch_cls_preds: torch.Tensor,
                   batch_box_preds: torch.Tensor, nms_cfg: NMSConfig):
    """Stage-1 proposals (roi_head_template.proposal_layer): (rois (B, K,
    7), roi_scores (B, K), roi_labels (B, K) 1-based, roi_valid (B, K)),
    K = nms_post_maxsize."""
    outs = []
    for cls, box in zip(batch_cls_preds, batch_box_preds):
        scores = torch.sigmoid(cls).max(-1).values
        labels = cls.argmax(-1).to(torch.int32) + 1
        idx, sc, vd = class_agnostic_nms(scores, box[:, :7], nms_cfg)
        outs.append((box[idx, :7], sc, labels[idx] * vd.to(torch.int32), vd))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(4))


def sample_rois_for_rcnn(generator: torch.Generator, cfg: RoISamplerConfig,
                         rois: torch.Tensor, roi_scores: torch.Tensor,
                         roi_labels: torch.Tensor, roi_valid: torch.Tensor,
                         gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                         gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One item: balanced RoI sampling + labels. Returns rois (M, 7),
    gt_of_rois (M, 7), gt_iou_of_rois (M,), roi_scores, roi_labels,
    roi_valid, reg_valid_mask, rcnn_cls_labels; M = roi_per_image."""
    m = cfg.roi_per_image
    n = rois.shape[0]
    dev = rois.device
    iou = boxes3d.boxes_iou3d(rois[:, :7], gt_boxes[:, :7])
    cand = gt_valid[None, :]
    if cfg.sample_roi_by_each_class:
        cand = cand & (roi_labels[:, None] == gt_classes[None, :])
    iou = torch.where(cand, iou, torch.full_like(iou, -1.0))
    overlaps, assignment = iou.max(dim=1)
    overlaps = overlaps.clamp(min=0.0)

    fg_thresh = min(cfg.reg_fg_thresh, cfg.cls_fg_thresh)
    is_fg = (overlaps >= fg_thresh) & roi_valid
    is_easy = (overlaps < cfg.cls_bg_thresh_lo) & roi_valid
    is_hard = (overlaps < cfg.reg_fg_thresh) \
        & (overlaps >= cfg.cls_bg_thresh_lo) & roi_valid

    inf = torch.full((n,), math.inf, device=dev)
    ar = torch.arange(n, device=dev, dtype=torch.float32)
    u1 = torch.rand((n,), generator=generator, device=dev)
    u2 = torch.rand((n,), generator=generator, device=dev)
    # fg: random rank, top quota
    fg_keys = torch.where(is_fg, u1, -inf)
    fg_val, fg_idx = torch.sort(fg_keys, descending=True, stable=True)
    k_fg = min(int(round(cfg.fg_ratio * m)), n)
    fg_val, fg_idx = fg_val[:k_fg], fg_idx[:k_fg]
    fg_ok = torch.isfinite(fg_val)

    # bg: hard and easy interleaved at hard_bg_ratio, random within each
    def positions(mask, start, step):
        order = torch.argsort(torch.where(mask, u2, inf), stable=True)
        pos = torch.where(ar < mask.sum(), start + ar / step, inf)
        out = torch.empty_like(pos)
        out[order] = pos
        return out
    bg_pos = torch.minimum(
        positions(is_hard, 0.0, max(cfg.hard_bg_ratio, 1e-3)),
        positions(is_easy, 0.5, max(1.0 - cfg.hard_bg_ratio, 1e-3)))
    bg_val, bg_idx = torch.sort(-bg_pos, descending=True, stable=True)
    bg_val, bg_idx = bg_val[:min(m, n)], bg_idx[:min(m, n)]
    bg_ok = torch.isfinite(bg_val)

    # fg slots first, then the bg ranking
    cand_idx = torch.cat([fg_idx, bg_idx])
    cand_ok = torch.cat([fg_ok, bg_ok])
    prio = torch.cat([
        torch.where(fg_ok, torch.arange(k_fg, device=dev,
                                        dtype=torch.float32), inf[:k_fg]),
        torch.where(bg_ok, 1e6 + torch.arange(bg_idx.shape[0], device=dev,
                                              dtype=torch.float32),
                    inf[:bg_idx.shape[0]])])
    top = torch.argsort(prio, stable=True)[:m]
    sel, sel_ok = cand_idx[top], cand_ok[top]
    okf = sel_ok[:, None].to(rois.dtype)

    s_overlaps = torch.where(sel_ok, overlaps[sel],
                             torch.zeros_like(overlaps[sel]))
    out = {
        "rois": rois[sel, :7] * okf,
        "gt_of_rois": gt_boxes[assignment[sel], :7] * okf,
        "gt_iou_of_rois": s_overlaps,
        "roi_scores": torch.where(sel_ok, roi_scores[sel],
                                  torch.zeros_like(roi_scores[sel])),
        "roi_labels": torch.where(sel_ok, roi_labels[sel],
                                  torch.zeros_like(roi_labels[sel])),
        "roi_valid": sel_ok,
    }
    out["reg_valid_mask"] = ((s_overlaps > cfg.reg_fg_thresh)
                             & sel_ok).to(torch.int32)
    if cfg.cls_score_type == "cls":
        cls = (s_overlaps > cfg.cls_fg_thresh).to(torch.float32)
        ignore = (s_overlaps > cfg.cls_bg_thresh) \
            & (s_overlaps < cfg.cls_fg_thresh)
        cls = torch.where(ignore, torch.full_like(cls, -1.0), cls)
    elif cfg.cls_score_type == "roi_iou":
        fg = s_overlaps > cfg.cls_fg_thresh
        bg = s_overlaps < cfg.cls_bg_thresh
        mid = ~fg & ~bg
        soft = (s_overlaps - cfg.cls_bg_thresh) \
            / (cfg.cls_fg_thresh - cfg.cls_bg_thresh)
        cls = fg.to(torch.float32) + mid * soft
    else:
        raise NotImplementedError(cfg.cls_score_type)
    out["rcnn_cls_labels"] = torch.where(sel_ok, cls,
                                         torch.full_like(cls, -1.0))
    return out


def canonical_gt_transform(rois: torch.Tensor, gt_of_rois: torch.Tensor
                           ) -> torch.Tensor:
    """GT boxes into each RoI's canonical frame with the heading flip and
    clamp (roi_head_template.assign_targets:113-133)."""
    two_pi = 2 * math.pi
    roi_ry = torch.remainder(rois[:, 6], two_pi)
    xyz = rotate_points_along_z((gt_of_rois[:, 0:3] - rois[:, 0:3])[:, None],
                                -roi_ry)[:, 0]
    heading = torch.remainder(gt_of_rois[:, 6] - roi_ry, two_pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + math.pi,
                                                    two_pi), heading)
    heading = torch.where(heading > math.pi, heading - two_pi, heading)
    heading = heading.clamp(-math.pi / 2, math.pi / 2)
    return torch.cat([xyz, gt_of_rois[:, 3:6], heading[:, None]], dim=-1)


def _local(rois: torch.Tensor, zero_heading: bool) -> torch.Tensor:
    out = torch.cat([torch.zeros_like(rois[:, 0:3]), rois[:, 3:]], dim=-1)
    if zero_heading:
        out = torch.cat([out[:, :6], torch.zeros_like(out[:, 6:7]),
                         out[:, 7:]], dim=-1)
    return out


def roi_box_loss(coder: ResidualCoder, rcnn_reg: torch.Tensor,
                 rois: torch.Tensor, gt_ct: torch.Tensor,
                 gt_src: torch.Tensor, reg_valid: torch.Tensor,
                 corner_weight: float = 1.0, reg_weight: float = 1.0,
                 use_corner_loss: bool = True,
                 denominator=loss_lib.local_count
                 ) -> Dict[str, torch.Tensor]:
    """Smooth-L1 on canonical residuals + the corner loss
    (roi_head_template.get_box_reg_layer_loss); flat (B*M, ...)."""
    reg_targets = coder.encode(gt_ct, _local(rois, True))
    fg = reg_valid.to(torch.float32)
    l1 = loss_lib.smooth_l1_loss(rcnn_reg, reg_targets)
    n_fg = denominator(fg.sum())
    out = {"rcnn_loss_reg": (l1.sum(-1) * fg).sum() / n_fg * reg_weight}
    if use_corner_loss:
        boxes = decode_roi_boxes(coder, rcnn_reg, rois)
        corner = loss_lib.corner_loss(boxes[:, :7], gt_src[:, :7])
        out["rcnn_loss_corner"] = (corner * fg).sum() / n_fg * corner_weight
    out["rcnn_loss_reg_total"] = sum(out.values())
    return out


def roi_cls_loss(rcnn_cls: torch.Tensor, cls_labels: torch.Tensor,
                 cls_weight: float = 1.0,
                 denominator=loss_lib.local_count) -> torch.Tensor:
    """BCE against (possibly soft) labels, -1 ignored
    (roi_head_template.get_box_cls_layer_loss)."""
    valid = (cls_labels >= 0).to(torch.float32)
    p = torch.sigmoid(rcnn_cls.reshape(-1)).clamp(1e-7, 1 - 1e-7)
    t = cls_labels.clamp(0.0, 1.0)
    bce = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    return (bce * valid).sum() / denominator(valid.sum()) * cls_weight


def decode_roi_boxes(coder: ResidualCoder, rcnn_reg: torch.Tensor,
                     rois: torch.Tensor) -> torch.Tensor:
    """Local refinement -> global boxes
    (roi_head_template.generate_predicted_boxes); flat (N, ...)."""
    boxes = coder.decode(rcnn_reg, _local(rois, False))
    xyz = rotate_points_along_z(boxes[:, None, 0:3], rois[:, 6])[:, 0]
    return torch.cat([xyz + rois[:, 0:3], boxes[:, 3:]], dim=-1)
