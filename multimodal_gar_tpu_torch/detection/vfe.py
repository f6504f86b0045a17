"""Voxel feature encoders of the detector zoo (detection/vfe.py; pcdet
backbones_3d/vfe/): MeanVFE, PillarVFE with its PFN layers (masked
BatchNorm over the points that exist) and the dynamic MeanVFE that voxelises
raw points on the device."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import MaskedBatchNorm, linear
from ..ops.geometry import safe_sqrt
from ..ops.voxel import INVALID_KEY


def mean_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """(B, M, P, C), (B, M) -> (B, M, C) point mean per voxel."""
    n = num_points.clamp(min=1).to(voxels.dtype)[..., None]
    return voxels.sum(dim=2) / n


class PFNLayer(nn.Module):
    """Linear (+ masked BN, eps 1e-3, momentum 0.9) + ReLU + masked max over
    the points axis (pillar_vfe.py:8-49)."""

    def __init__(self, cin: int, out_channels: int, use_norm: bool = True,
                 last_layer: bool = False, *, device, generator):
        super().__init__()
        self.last_layer = last_layer
        ch = out_channels if last_layer else out_channels // 2
        self.linear = linear(cin, ch, bias=not use_norm, device=device,
                             generator=generator)
        self.norm = MaskedBatchNorm(ch, 1e-3, device=device) \
            if use_norm else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x, mask)
        x = F.relu(x) * mask[..., None].to(x.dtype)
        x_max = torch.where(mask[..., None], x,
                            torch.full_like(x, float("-inf"))).amax(dim=2)
        x_max = torch.where(mask.any(dim=2)[..., None], x_max,
                            torch.zeros_like(x_max))
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max[:, :, None].expand_as(x)], dim=-1)


class PillarVFE(nn.Module):
    """Pillar feature net (pillar_vfe.py:52-123): voxels (B, P, N, 4) xyz +
    intensity, coords (B, P, 3) zyx, num_points (B, P), valid (B, P) ->
    (B, P, num_filters[-1])."""

    def __init__(self, num_filters: Tuple[int, ...] = (64,),
                 voxel_size=(0.16, 0.16, 4.0),
                 point_cloud_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
                 use_norm: bool = True, with_distance: bool = False,
                 use_absolute_xyz: bool = True, num_point_features: int = 4,
                 *, device, generator):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.with_distance = with_distance
        self.use_absolute_xyz = use_absolute_xyz
        cin = (num_point_features if use_absolute_xyz
               else num_point_features - 3) + 6 + int(with_distance)
        for i, ch in enumerate(num_filters):
            last = i == len(num_filters) - 1
            self.add_module(f"pfn{i}", PFNLayer(
                cin, ch, use_norm, last_layer=last, device=device,
                generator=generator))
            cin = ch
        self.num_layers = len(num_filters)

    def forward(self, voxels, coords, num_points, valid):
        n = voxels.shape[2]
        cnt = num_points.clamp(min=1).to(voxels.dtype)
        mean = voxels[..., :3].sum(dim=2) / cnt[..., None]
        f_cluster = voxels[..., :3] - mean[:, :, None]
        vx, vy, vz = self.voxel_size
        pr = self.point_cloud_range
        c = coords.to(voxels.dtype)
        centers = torch.stack([c[..., 2] * vx + (vx / 2 + pr[0]),
                               c[..., 1] * vy + (vy / 2 + pr[1]),
                               c[..., 0] * vz + (vz / 2 + pr[2])], dim=-1)
        f_center = voxels[..., :3] - centers[:, :, None]
        feats = [voxels if self.use_absolute_xyz else voxels[..., 3:],
                 f_cluster, f_center]
        if self.with_distance:
            feats.append(safe_sqrt((voxels[..., :3] ** 2).sum(-1))[..., None])
        x = torch.cat(feats, dim=-1)
        pt_mask = (torch.arange(n, device=voxels.device)[None, None, :]
                   < num_points[..., None]) & valid[..., None]
        x = x * pt_mask[..., None].to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn{i}")(x, pt_mask)
        return x * valid[..., None].to(x.dtype)


def dynamic_mean_vfe(points: torch.Tensor, point_valid: torch.Tensor,
                     voxel_size: Sequence[float], pc_range: Sequence[float],
                     grid_size: Sequence[int], max_voxels: int):
    """Raw points (B, N, C) -> (voxel mean features (B, V, C), zyx coords
    (B, V, 3), valid (B, V)) with V = ``max_voxels``: the sorted unique
    voxel keys (the smallest ``max_voxels`` kept) and a segment mean.
    Points outside the range are dropped; coords of unused rows are 0."""
    nx, ny, nz = grid_size
    b, n, c = points.shape
    dev = points.device
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=dev)
    cidx = torch.floor((points[..., :3] - lo) / vs).to(torch.int64)
    hi = torch.tensor([nx, ny, nz], device=dev)
    inb = ((cidx >= 0) & (cidx < hi)).all(-1) & point_valid
    key = torch.where(inb, (cidx[..., 2] * ny + cidx[..., 1]) * nx
                      + cidx[..., 0], INVALID_KEY)
    sk = torch.sort(key, dim=1).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    keep = first & (sk != INVALID_KEY)
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep & (rank < max_voxels), rank, max_voxels)
    uniq = torch.full((b, max_voxels + 1), INVALID_KEY, dtype=torch.int64,
                      device=dev)
    uniq.scatter_(1, slot, sk)
    uniq = uniq[:, :max_voxels]
    uvalid = uniq != INVALID_KEY
    seg = torch.searchsorted(uniq.contiguous(), key.contiguous())
    hit = inb & (seg < max_voxels) & (torch.gather(
        uniq, 1, seg.clamp(max=max_voxels - 1)) == key)
    seg = torch.where(hit, seg, max_voxels)
    sums = torch.zeros((b, max_voxels + 1, c), dtype=points.dtype,
                       device=dev)
    sums.scatter_add_(1, seg[..., None].expand(-1, -1, c),
                      points * hit[..., None].to(points.dtype))
    cnts = torch.zeros((b, max_voxels + 1), dtype=points.dtype, device=dev)
    cnts.scatter_add_(1, seg, hit.to(points.dtype))
    feats = sums[:, :max_voxels] / cnts[:, :max_voxels, None].clamp(min=1.0)
    safe = torch.where(uvalid, uniq, 0)
    coords = torch.stack([safe // (ny * nx), (safe // nx) % ny, safe % nx],
                         dim=-1).to(torch.int32)
    return feats, coords, uvalid
