"""LiDAR branch (models/lidar_backbone.py:21-113): MeanVFE -> VoxelBackbone8x
-> ROI grid pool -> attention -> 512 embedding. The attention is one of:

  - default: per-person 3D non-local block over the G^3 grid, G^3 * C in;
  - ``two_stage_att``: mean over z, SpaTempSelfAtt 'flat' (2D within each
    person's G x G grid, flattened, 1D across the people), G^2 * C in;
  - ``self_att_inter_person``: mean over z, one 3D non-local block across
    (person, G, G), G^2 * C in;
  - ``self_att_use: false``: no attention and no embedding, the grid pool's
    shared FC (with its dropout in training) gives the features.

The shared FC is built and run only in the last case, as in the JAX
package. ``dtype`` bfloat16 (``model.dtype``): MeanVFE's
features are rounded to bf16 (models/lidar_backbone.py:62), and the sparse
backbone, the grid pool's Dense layers, the attention and the embedding
compute in bf16, each as its JAX module does at bf16."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..utils.profiling import span
from .layers import KAIMING, cast, dense, linear
from .nonlocal_block import NLBlockND
from .roi_grid_pool import ROIGridPool
from .spa_temp import SpaTempSelfAtt
from .sparse_backbone import SparseTensor, VoxelBackbone8x


def mean_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """Mean of the real points of each voxel: (B, M, P, C), (B, M) ->
    (B, M, C)."""
    total = torch.sum(voxels, dim=2)
    return total / torch.clamp(num_points, min=1).to(total.dtype)[..., None]


class LiDARBackbone(nn.Module):

    def __init__(self, cfg, pc_cfg, *, device, generator,
                 dtype: torch.dtype = torch.float32):
        """cfg: LiDARBackboneConfig, pc_cfg: PointCloudConfig."""
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.grid_size = cfg.grid_pool_size
        nx, ny, nz = pc_cfg.grid_size
        # spconv convention: sparse_shape = (Z + 1, Y, X)
        self.spatial_shape = (nz + 1, ny, nx)
        self.backbone3d = VoxelBackbone8x(
            pc_cfg.num_point_features, x_window=cfg.x_window,
            max_voxels_per_stage=cfg.max_voxels_per_stage, dtype=dtype, **kw)
        if cfg.two_stage_att:
            self.mode = "two_stage"
        elif not cfg.self_att_use:
            self.mode = "shared_fc"
        elif cfg.self_att_inter_person:
            self.mode = "inter_person"
        else:
            self.mode = "per_person"
        self.roi_grid_pool = ROIGridPool(
            cfg, pc_cfg, shared_fc=self.mode == "shared_fc", dtype=dtype,
            **kw)
        c = sum(lc.mlps[1] for lc in cfg.pool_layers)
        g = self.grid_size
        if self.mode == "two_stage":
            self.self_att = SpaTempSelfAtt(c, max(c // 8, 1), pool="flat",
                                           patch_positions=g * g, dtype=dtype,
                                           **kw)
        elif self.mode != "shared_fc":
            self.self_att = NLBlockND(c, max(c // 8, 1), dtype=dtype, **kw)
        if self.mode != "shared_fc":
            width = g ** 3 * c if self.mode == "per_person" else g * g * c
            self.embedding = linear(width, cfg.embedding_dim, gain=KAIMING,
                                    **kw)

    def forward(self, voxels: torch.Tensor, voxel_coords: torch.Tensor,
                voxel_num_points: torch.Tensor, voxel_valid: torch.Tensor,
                rois: torch.Tensor, roi_valid: torch.Tensor,
                rulebook: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """-> (B, N, embedding_dim) per-person features, zero for padded
        people. Without a ``rulebook`` the sparse backbone builds its maps
        on the device."""
        with span("lidar.vfe"):
            feats = mean_vfe(voxels, voxel_num_points)
            feats = cast(feats * voxel_valid[..., None].to(feats.dtype),
                         self.dtype)
        with span("lidar.sparse_backbone"):
            ms = self.backbone3d(SparseTensor(
                feats, voxel_coords, voxel_valid, self.spatial_shape),
                rulebook)
        with span("lidar.grid_pool"):
            pooled, shared = self.roi_grid_pool(ms, rois, roi_valid)
        if self.mode == "shared_fc":
            return shared
        with span("lidar.embed"):
            b, n, g3, c = pooled.shape                     # (B, N, G3, C)
            g = self.grid_size
            if self.mode == "two_stage":
                x = pooled.reshape(b * n, g, g, g, c).mean(dim=3)
                x = self.self_att(x)                       # (B N, G G C)
            elif self.mode == "inter_person":
                # the people as the block's third axis; its training
                # BatchNorm counts every row
                x = self.self_att(
                    pooled.reshape(b, n, g, g, g, c).mean(dim=4))
            else:
                x = self.self_att(pooled.reshape(b * n, g, g, g, c),
                                  roi_valid.reshape(b * n))
            x = dense(self.embedding, x.reshape(b, n, -1), self.dtype)
            return x * roi_valid[..., None].to(x.dtype)
