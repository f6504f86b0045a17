"""Detection loss library (train/loss_lib.py; pcdet utils/loss_utils.py):
sigmoid focal, smooth-L1 and L1 regression, per-anchor weighted softmax
cross-entropy, the corner loss and CenterNet's gaussian focal loss, batched
with explicit per-anchor weights."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes3d import boxes_to_corners_3d


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


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    loss = (pred - target).abs()
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


def gaussian_focal_loss(pred_heatmap: torch.Tensor, gt_heatmap: torch.Tensor,
                        alpha: float = 2.0, beta: float = 4.0,
                        eps: float = 1e-6) -> torch.Tensor:
    """CenterNet heatmap focal loss, mean over positive centres."""
    pos = (gt_heatmap >= 1.0).to(pred_heatmap.dtype)
    neg = 1.0 - pos
    p = pred_heatmap.clamp(eps, 1 - eps)
    pos_loss = -torch.log(p) * torch.pow(1 - p, alpha) * pos
    neg_loss = -torch.log(1 - p) * torch.pow(p, alpha) \
        * torch.pow(1 - gt_heatmap, beta) * neg
    n_pos = pos.sum().clamp(min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / n_pos


def set_random_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed helper (pcdet common_utils.set_random_seed): seeds numpy's
    legacy state and returns a torch generator on ``device`` seeded with
    ``seed`` (torch's global stream is left alone)."""
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(int(seed))
