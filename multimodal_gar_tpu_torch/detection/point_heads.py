"""Point-wise heads: foreground segmentation and point-based box
regression (detection/point_heads.py; pcdet point_head_simple.py,
point_head_box.py and the target assignment of point_head_template.py).

The heads are stacks of Linear (no bias) -> BatchNorm (eps 1e-3, flax's
momentum 0.99, every row in the training statistics) -> ReLU, named as the
flax modules are (``cls_fc_0``, ``cls_fc_0_bn``, ...); the reference's
Conv1d(k=1) is the Linear. Targets and losses are batched over (B, N)
points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, linear
from ..ops import boxes3d
from ..train import loss_lib
from .box_coders import PointResidualCoder


@dataclasses.dataclass(frozen=True)
class PointHeadConfig:
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    num_class: int = 3
    class_agnostic: bool = False           # PointHeadSimple uses 1 logit
    gt_extra_width: Tuple[float, float, float] = (0.2, 0.2, 0.2)
    cls_weight: float = 1.0
    reg_weight: float = 1.0


def add_dense_stack(parent: nn.Module, cin: int, widths: Sequence[int],
                    name: str, *, device, generator) -> int:
    """Adds ``{name}_{i}`` (Linear, no bias) and ``{name}_{i}_bn`` to
    ``parent`` for each width (flax ``_mlp``); returns the last width."""
    for i, w in enumerate(widths):
        parent.add_module(f"{name}_{i}", linear(
            cin, w, bias=False, device=device, generator=generator))
        parent.add_module(f"{name}_{i}_bn", BatchNorm(
            w, 1e-3, device=device, momentum=0.99))
        cin = w
    return cin


def run_dense_stack(parent: nn.Module, x: torch.Tensor, n: int,
                    name: str) -> torch.Tensor:
    """The stack ``add_dense_stack`` added: Linear -> BN -> ReLU, n times,
    over (..., C) rows."""
    for i in range(n):
        x = getattr(parent, f"{name}_{i}")(x)
        x = F.relu(getattr(parent, f"{name}_{i}_bn")(x))
    return x


class PointHeadSimple(nn.Module):
    """Per-point foreground classifier (point_head_simple.py)."""

    def __init__(self, cin: int, cfg: PointHeadConfig, *, device,
                 generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        h = add_dense_stack(self, cin, cfg.cls_fc, "cls_fc", **kw)
        self.cls_out = linear(h, 1 if cfg.class_agnostic else cfg.num_class,
                              **kw)

    def forward(self, point_features: torch.Tensor) -> Dict[str,
                                                            torch.Tensor]:
        h = run_dense_stack(self, point_features, len(self.cfg.cls_fc),
                            "cls_fc")
        logits = self.cls_out(h)
        return {"point_cls_preds": logits,
                "point_cls_scores": torch.sigmoid(logits).max(-1).values}


class PointHeadBox(nn.Module):
    """Per-point class + box regression (point_head_box.py)."""

    def __init__(self, cin: int, cfg: PointHeadConfig,
                 coder: PointResidualCoder = PointResidualCoder(), *,
                 device, generator):
        super().__init__()
        self.cfg, self.coder = cfg, coder
        kw = dict(device=device, generator=generator)
        hc = add_dense_stack(self, cin, cfg.cls_fc, "cls_fc", **kw)
        hb = add_dense_stack(self, cin, cfg.reg_fc, "reg_fc", **kw)
        self.cls_out = linear(hc, cfg.num_class, **kw)
        self.box_out = linear(hb, coder.code_size, **kw)
        with torch.no_grad():      # normal(0.001), as the JAX head draws it
            self.box_out.weight.copy_(torch.randn(
                self.box_out.weight.shape, generator=generator).to(device)
                * 0.001)

    def forward(self, point_features: torch.Tensor) -> Dict[str,
                                                            torch.Tensor]:
        hc = run_dense_stack(self, point_features, len(self.cfg.cls_fc),
                             "cls_fc")
        hb = run_dense_stack(self, point_features, len(self.cfg.reg_fc),
                             "reg_fc")
        cls = self.cls_out(hc)
        return {"point_cls_preds": cls, "point_box_preds": self.box_out(hb),
                "point_cls_scores": torch.sigmoid(cls).max(-1).values}


def assign_point_targets(points_xyz: torch.Tensor, point_valid: torch.Tensor,
                         gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                         gt_valid: torch.Tensor,
                         extra_width=(0.2, 0.2, 0.2)):
    """Point labels: the class of the first GT box that holds the point,
    -1 in the enlarged boxes' ignore ring and on invalid points, else 0
    (point_head_template.assign_stack_targets). Batched: points (B, N, 3),
    GT (B, G, ...). Returns (labels (B, N) int, box_of_point (B, N, 7),
    gt_idx (B, N))."""
    inside = boxes3d.points_in_boxes(points_xyz, gt_boxes) \
        & gt_valid[..., None, :]
    enlarged = boxes3d.enlarge_box3d(gt_boxes, extra_width)
    in_ring = boxes3d.points_in_boxes(points_xyz, enlarged) \
        & gt_valid[..., None, :]
    gt_idx = torch.argmax(inside.to(torch.uint8), dim=-1)
    cls = torch.gather(gt_classes, -1, gt_idx)
    labels = torch.where(inside.any(-1), cls,
                         torch.where(in_ring.any(-1), -1, 0))
    labels = torch.where(point_valid, labels, -1)
    box = torch.gather(gt_boxes, -2, gt_idx[..., None].expand(
        gt_idx.shape + (gt_boxes.shape[-1],)))
    return labels, box, gt_idx


def point_cls_loss(logits: torch.Tensor, labels: torch.Tensor,
                   num_class: int, cls_weight: float = 1.0) -> torch.Tensor:
    """Focal point classification loss over the cared points
    (point_head_template.get_cls_layer_loss)."""
    cared = labels >= 0
    pos = labels > 0
    if logits.shape[-1] == 1:                   # class-agnostic
        one_hot = pos[..., None].to(logits.dtype)
    else:
        one_hot = F.one_hot(torch.where(cared, labels, 0).long(),
                            num_class + 1)[..., 1:].to(logits.dtype)
    w = cared.to(torch.float32)
    w = w / torch.clamp(pos.sum(-1, keepdim=True).to(torch.float32),
                        min=1.0)
    return loss_lib.sigmoid_focal_loss(logits, one_hot, w).sum() \
        / logits.shape[0] * cls_weight


def point_box_loss(coder: PointResidualCoder, box_preds: torch.Tensor,
                   points_xyz: torch.Tensor, labels: torch.Tensor,
                   gt_of_points: torch.Tensor, reg_weight: float = 1.0
                   ) -> torch.Tensor:
    """Smooth-L1 on PointResidualCoder targets of the foreground points
    (point_head_box.get_loss)."""
    targets = coder.encode(gt_of_points, points_xyz,
                           torch.clamp(labels, min=1))
    w = (labels > 0).to(torch.float32)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    return loss_lib.smooth_l1_loss(box_preds, targets, w).sum() \
        / box_preds.shape[0] * reg_weight
