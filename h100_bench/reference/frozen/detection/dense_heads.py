"""AnchorHeadSingle with its loss and decode (detection/dense_heads.py; pcdet
anchor_head_single.py, anchor_head_template.py). Outputs NHWC."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import loss_lib
from .bev import conv2d
from .box_coders import ResidualCoder
from .target_assign import AnchorSet, anchor_tensor, assign_targets


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """pcdet common_utils.limit_period: wrap an angle into one period."""
    return val - torch.floor(val / period + offset) * period


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class AnchorHeadConfig:
    num_class: int = 3
    use_direction_classifier: bool = True
    num_dir_bins: int = 2
    dir_offset: float = 0.78539          # pi/4
    dir_limit_offset: float = 0.0
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    dir_weight: float = 0.2
    code_weights: Tuple[float, ...] = (1.0,) * 7
    match_height: bool = False
    norm_by_num_examples: bool = False
    encode_angle_by_sincos: bool = False


class AnchorHeadSingle(nn.Module):
    """1x1-conv anchor head over an NCHW BEV map
    (anchor_head_single.py:41-75); outputs NHWC."""

    def __init__(self, cin: int, cfg: AnchorHeadConfig,
                 num_anchors_per_loc: int, code_size: int = 7, *, device,
                 generator):
        super().__init__()
        a = num_anchors_per_loc
        kw = dict(bias=True, device=device, generator=generator)
        # focal-init bias pi = 0.01 (anchor_head_single.py:36-39)
        self.conv_cls = conv2d(cin, a * cfg.num_class, 1,
                               bias_value=-float(np.log((1 - 0.01) / 0.01)),
                               **kw)
        self.conv_box = conv2d(cin, a * code_size, 1, std=0.001, **kw)
        self.conv_dir_cls = conv2d(cin, a * cfg.num_dir_bins, 1, **kw) \
            if cfg.use_direction_classifier else None

    def forward(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"cls_preds": _nhwc(self.conv_cls(bev)),
               "box_preds": _nhwc(self.conv_box(bev))}
        if self.conv_dir_cls is not None:
            out["dir_cls_preds"] = _nhwc(self.conv_dir_cls(bev))
        return out


def _flat(x: torch.Tensor, last: int) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, last)


def anchor_head_loss(preds: Dict[str, torch.Tensor], anchor_set: AnchorSet,
                     coder: ResidualCoder, cfg: AnchorHeadConfig,
                     gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                     gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RPN loss (anchor_head_template.py:101-223): focal classification +
    smooth-L1 location (+ direction CE); gt_* are (B, G, ...)."""
    labels, reg_targets, _ = assign_targets(
        anchor_set, coder, gt_boxes, gt_classes, gt_valid,
        match_height=cfg.match_height,
        norm_by_num_examples=cfg.norm_by_num_examples)
    b = labels.shape[0]
    cls_preds = _flat(preds["cls_preds"], cfg.num_class)
    box_preds = _flat(preds["box_preds"], coder.full_code_size)

    cared = labels >= 0
    positives = labels > 0
    pos_norm = positives.sum(1, keepdim=True).to(torch.float32).clamp(min=1.0)
    cls_weights = cared.to(torch.float32) / pos_norm
    reg_w = positives.to(torch.float32) / pos_norm

    one_hot = F.one_hot(torch.where(cared, labels, 0).long(),
                        cfg.num_class + 1)[..., 1:].to(cls_preds.dtype)
    cls_loss = loss_lib.sigmoid_focal_loss(
        cls_preds, one_hot, cls_weights).sum() / b * cfg.cls_weight

    anchors = anchor_tensor(anchor_set, "anchors", gt_boxes.device)
    if not cfg.encode_angle_by_sincos:
        # sin(a - b) decomposition of the heading residual
        pr, tr = box_preds[..., 6:7], reg_targets[..., 6:7]
        box_preds_s = torch.cat([box_preds[..., :6],
                                 torch.sin(pr) * torch.cos(tr),
                                 box_preds[..., 7:]], dim=-1)
        reg_targets_s = torch.cat([reg_targets[..., :6],
                                   torch.cos(pr) * torch.sin(tr),
                                   reg_targets[..., 7:]], dim=-1)
    else:
        box_preds_s, reg_targets_s = box_preds, reg_targets
    code_w = torch.tensor(cfg.code_weights[:box_preds_s.shape[-1]],
                          dtype=box_preds.dtype, device=box_preds.device)
    loc = loss_lib.smooth_l1_loss(box_preds_s * code_w,
                                  reg_targets_s * code_w, reg_w)
    losses = {"rpn_loss_cls": cls_loss,
              "rpn_loss_loc": loc.sum() / b * cfg.loc_weight}

    if cfg.use_direction_classifier and "dir_cls_preds" in preds:
        rot_gt = reg_targets[..., 6] + anchors[None, :, 6]
        offset_rot = limit_period(rot_gt - cfg.dir_offset, 0, 2 * np.pi)
        dir_t = (offset_rot / (2 * np.pi / cfg.num_dir_bins)).to(
            torch.int32).clamp(0, cfg.num_dir_bins - 1)
        dir_logits = _flat(preds["dir_cls_preds"], cfg.num_dir_bins)
        w = positives.to(torch.float32)
        w = w / w.sum(-1, keepdim=True).clamp(min=1.0)
        losses["rpn_loss_dir"] = loss_lib.weighted_cross_entropy(
            dir_logits, F.one_hot(dir_t.long(), cfg.num_dir_bins).to(
                dir_logits.dtype), w).sum() / b * cfg.dir_weight
    losses["rpn_loss"] = sum(losses.values())
    return losses


def decode_anchor_preds(preds: Dict[str, torch.Tensor], anchor_set: AnchorSet,
                        coder: ResidualCoder, cfg: AnchorHeadConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls logits (B, N, num_class), boxes (B, N, 7)):
    anchor_head_template.generate_predicted_boxes."""
    cls_preds = _flat(preds["cls_preds"], cfg.num_class)
    box_preds = _flat(preds["box_preds"], coder.full_code_size)
    anchors = anchor_tensor(anchor_set, "anchors", box_preds.device)
    boxes = coder.decode(box_preds, anchors[None])
    if cfg.use_direction_classifier and "dir_cls_preds" in preds:
        dir_labels = _flat(preds["dir_cls_preds"], cfg.num_dir_bins).argmax(-1)
        period = 2 * np.pi / cfg.num_dir_bins
        dir_rot = limit_period(boxes[..., 6] - cfg.dir_offset,
                               cfg.dir_limit_offset, period)
        heading = dir_rot + cfg.dir_offset + period * dir_labels.to(
            boxes.dtype)
        boxes = torch.cat([boxes[..., :6], heading[..., None],
                           boxes[..., 7:]], dim=-1)
    return cls_preds, boxes


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
