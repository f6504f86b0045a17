"""The detection losses (train/loss_lib.py; pcdet utils/loss_utils.py):
sigmoid focal, smooth-L1, weighted softmax cross-entropy and the corner
loss. The denominator ``local_count`` is the frozen train/loss_lib.py's."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.boxes3d import boxes_to_corners_3d
from ..train.loss_lib import local_count  # noqa: F401


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Per-element sigmoid focal loss, scaled by anchor weights."""
    p = torch.sigmoid(logits)
    alpha_w = alpha * targets + (1 - alpha) * (1 - targets)
    pt = targets * (1 - p) + (1 - targets) * p
    focal = alpha_w * torch.pow(pt, gamma)
    bce = logits.clamp(min=0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))
    loss = focal * bce
    return loss * weights[..., None] if weights.ndim == loss.ndim - 1 \
        else loss * weights


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   beta: float = 1.0 / 9.0) -> torch.Tensor:
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy(logits: torch.Tensor, one_hot: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Per-anchor weighted softmax CE."""
    return -(one_hot * F.log_softmax(logits, dim=-1)).sum(-1) * weights


def corner_loss(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                beta: float = 1.0) -> torch.Tensor:
    """Per-box corner-distance loss with the flipped-heading minimum
    (loss_utils.get_corner_loss_lidar)."""
    pc = boxes_to_corners_3d(pred_boxes)
    gc = boxes_to_corners_3d(gt_boxes)
    flip = gt_boxes.clone()
    flip[:, 6] = flip[:, 6] + math.pi
    gcf = boxes_to_corners_3d(flip)
    d = torch.minimum(torch.linalg.vector_norm(pc - gc, dim=-1),
                      torch.linalg.vector_norm(pc - gcf, dim=-1))   # (N, 8)
    huber = torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta)
    return huber.mean(dim=-1)
