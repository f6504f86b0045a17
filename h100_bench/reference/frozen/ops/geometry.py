"""Pairwise geometric primitives of the grouping model (ops/geometry.py).

Batched over any leading dimensions: where the JAX package vmaps a function
of (N, ...) rows, these take (..., N, ...).
"""
from __future__ import annotations

import torch


def safe_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt that is 0 (not NaN) at and below ``eps``."""
    return torch.where(x > eps, torch.sqrt(torch.clamp(x, min=eps)), 0.0)


def pairwise_giou_2d(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise generalized IoU of (..., N, 4) xyxy boxes -> (..., N, N)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)

    def pair(a, op):
        return op(a[..., :, None], a[..., None, :])

    inter = (torch.clamp(pair(x2, torch.minimum) - pair(x1, torch.maximum),
                         min=0)
             * torch.clamp(pair(y2, torch.minimum) - pair(y1, torch.maximum),
                           min=0))
    union = area[..., :, None] + area[..., None, :] - inter
    eps = 1e-7
    iou = inter / torch.clamp(union, min=eps)
    enclose = ((pair(x2, torch.maximum) - pair(x1, torch.minimum))
               * (pair(y2, torch.maximum) - pair(y1, torch.minimum)))
    return iou - (enclose - union) / torch.clamp(enclose, min=eps)


def pairwise_euclidean(points: torch.Tensor,
                       zero_diagonal: bool = True) -> torch.Tensor:
    """Pairwise Euclidean distances of (..., N, D) points -> (..., N, N),
    through the expanded quadratic form clamped at 0."""
    sq = torch.sum(points * points, dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :] \
        - 2.0 * points @ points.transpose(-1, -2)
    d2 = torch.clamp(d2, min=0.0)
    if zero_diagonal:
        n = points.shape[-2]
        d2 = d2 * (1.0 - torch.eye(n, dtype=points.dtype,
                                   device=points.device))
    return safe_sqrt(d2)


def rotate_points_along_z(points: torch.Tensor,
                          angle: torch.Tensor) -> torch.Tensor:
    """Rotate (B, N, 3+) points by per-row yaw angles (B,): p @ R with
    R = [[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]."""
    cosa, sina = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(angle), torch.ones_like(angle)
    rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros,
                       zeros, zeros, ones], dim=-1).reshape(-1, 3, 3)
    xyz = torch.einsum("bnk,bkm->bnm", points[..., :3], rot)
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def pairwise_cosine_similarity(x: torch.Tensor,
                               eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarity of (..., N, D) rows -> (..., N, N)."""
    norm = safe_sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    xn = x / torch.clamp(norm, min=eps)
    return xn @ xn.transpose(-1, -2)
