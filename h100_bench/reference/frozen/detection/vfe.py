"""MeanVFE (detection/vfe.py)."""
from __future__ import annotations

import torch


def mean_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """(B, M, P, C), (B, M) -> (B, M, C) point mean per voxel."""
    n = num_points.clamp(min=1).to(voxels.dtype)[..., None]
    return voxels.sum(dim=2) / n
