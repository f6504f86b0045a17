"""LiDAR branch (models/lidar_backbone.py:21-113): MeanVFE -> VoxelBackbone8x
-> ROI grid pool -> per-person 3D non-local block over the G^3 grid ->
G^3 * C -> 512 embedding. Training runs the same path: the shared FC and its
dropout stay skipped under ``self_att_use``, as in the JAX package."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import KAIMING, linear
from .nonlocal_block import NLBlockND
from .roi_grid_pool import ROIGridPool
from .sparse_backbone import SparseTensor, VoxelBackbone8x


def mean_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """Mean of the real points of each voxel: (B, M, P, C), (B, M) ->
    (B, M, C)."""
    total = torch.sum(voxels, dim=2)
    return total / torch.clamp(num_points, min=1).to(total.dtype)[..., None]


class LiDARBackbone(nn.Module):

    def __init__(self, cfg, pc_cfg, *, device, generator):
        """cfg: LiDARBackboneConfig, pc_cfg: PointCloudConfig."""
        super().__init__()
        if (not cfg.self_att_use or cfg.two_stage_att
                or cfg.self_att_inter_person):
            raise NotImplementedError(
                "only the per-person 3D non-local LiDAR path is ported")
        kw = dict(device=device, generator=generator)
        self.grid_size = cfg.grid_pool_size
        nx, ny, nz = pc_cfg.grid_size
        # spconv convention: sparse_shape = (Z + 1, Y, X)
        self.spatial_shape = (nz + 1, ny, nx)
        self.backbone3d = VoxelBackbone8x(pc_cfg.num_point_features,
                                          x_window=cfg.x_window, **kw)
        self.roi_grid_pool = ROIGridPool(cfg, pc_cfg, **kw)
        c = sum(lc.mlps[1] for lc in cfg.pool_layers)
        self.self_att = NLBlockND(c, max(c // 8, 1), **kw)
        self.embedding = linear(self.grid_size ** 3 * c, cfg.embedding_dim,
                                gain=KAIMING, **kw)

    def forward(self, voxels: torch.Tensor, voxel_coords: torch.Tensor,
                voxel_num_points: torch.Tensor, voxel_valid: torch.Tensor,
                rois: torch.Tensor, roi_valid: torch.Tensor,
                rulebook: Dict[str, torch.Tensor]) -> torch.Tensor:
        """-> (B, N, embedding_dim) per-person features, zero for padded
        people."""
        feats = mean_vfe(voxels, voxel_num_points)
        feats = feats * voxel_valid[..., None].to(feats.dtype)
        ms = self.backbone3d(SparseTensor(feats, voxel_coords, voxel_valid,
                                          self.spatial_shape), rulebook)
        pooled = self.roi_grid_pool(ms, rois, roi_valid)   # (B, N, G3, C)
        b, n, g3, c = pooled.shape
        g = self.grid_size
        x = self.self_att(pooled.reshape(b * n, g, g, g, c),
                          roi_valid.reshape(b * n))
        x = self.embedding(x.reshape(b, n, g3 * c))
        return x * roi_valid[..., None].to(x.dtype)
