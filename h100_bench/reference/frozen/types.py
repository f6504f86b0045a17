"""Batch and model outputs as dataclasses of tensors (types.py:15-52).

Same fields, shapes and masks as the JAX package's pytrees: fixed-shape,
padded, with explicit validity masks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


def _to(value, device):
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, tuple):
        return tuple(_to(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _to(v, device) for k, v in value.items()}
    raise TypeError(type(value))


class _ToDevice:
    def to(self, device):
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Batch(_ToDevice):
    """One padded batch of JRDB-Act key-frame samples."""
    images: torch.Tensor                 # (B, T, H, W, 3) float or uint8
    boxes2d: torch.Tensor                # (B, N, 4) xyxy pixels
    boxes3d: torch.Tensor                # (B, N, 7) cx cy cz dx dy dz yaw
    person_valid: torch.Tensor           # (B, N) bool
    social_group_id: torch.Tensor        # (B, N) int32, -1 padded
    actions: torch.Tensor                # (B, N, 27) multi-hot float
    social_group_activity: torch.Tensor  # (B, N, 27) multi-hot float
    voxels: torch.Tensor                 # (B, M, P, 4) raw per-voxel points
    voxel_coords: torch.Tensor           # (B, M, 3) int32 zyx
    voxel_num_points: torch.Tensor       # (B, M) int32
    voxel_valid: torch.Tensor            # (B, M) bool
    seq_id: torch.Tensor                 # (B,) int32
    frame_id: torch.Tensor               # (B,) int32
    # host-built sparse-conv rulebook (data/rulebook.py): dict of (B, ...)
    rulebook: Optional[Dict[str, torch.Tensor]] = None
    e_hat: Optional[torch.Tensor] = None     # (B, max_vecs, N) float32
    e_count: Optional[torch.Tensor] = None   # (B,) int32


@dataclasses.dataclass
class ModelOutputs(_ToDevice):
    """Padded model outputs; every (B, N, ...) row is zero for invalid
    actors."""
    a_theta: torch.Tensor                # (B, N, N) predicted adjacency
    pose: Tuple[torch.Tensor, ...]       # 3 x (B, N, 4) softmax
    interaction: Tuple[torch.Tensor, ...]     # (B,N,2),(B,N,4),(B,N,7),(B,N,5)
    sg_pose: Tuple[torch.Tensor, ...]         # 3 x (B, N, 4) sigmoid
    sg_interaction: Tuple[torch.Tensor, ...]  # as interaction, sigmoid
    card: torch.Tensor                   # (B, 1) predicted #groups
    group_ids: torch.Tensor              # (B, N) int32 decoded groups
    rgb_features: Optional[torch.Tensor] = None     # (B, N, D)
    lidar_features: Optional[torch.Tensor] = None   # (B, N, D)
    fused_features: Optional[torch.Tensor] = None   # (B, N, D)
