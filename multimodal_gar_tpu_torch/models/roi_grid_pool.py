"""ROI grid pooling over the multi-scale sparse features
(models/roi_grid_pool.py:29-249).

Per box: a G x G x G grid of query points (yaw-rotated, box-local), each
pooling <= nsample neighbour voxels within a per-scale radius through a
small per-scale MLP, max- or mean-pooled (``pool_method``) and concatenated
over the scales. The neighbours are selected as the JAX
``NeighborVoxelPoolLayer`` routes it: the per-box culled query
(ops/voxel.py: voxel_query_boxed) when ``pool_cull_k > 0`` and not
``voxel_query_exact``, else the dense query over every voxel of the scale
(ops/voxel.py: voxel_query, in chunks of queries); then the row gather
(ops/kernels/neighbour_gather.py), whose backward is a kernel on the card.

``dtype`` bfloat16: the MLPs' Dense layers (and the shared FC's) compute in
bf16 and their masked BatchNorms, built without a dtype in flax, return
float32 (models/roi_grid_pool.py:88-93, :160-182, :238-246), so the pooled
features are float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import rotate_points_along_z
from ..ops.kernels.neighbour_gather import neighbour_gather
from ..ops.voxel import get_voxel_centers, voxel_query, voxel_query_boxed
from .layers import KAIMING, Dropout, MaskedBatchNorm, dense, linear
from .sparse_backbone import BACKBONE_CHANNELS, BACKBONE_STRIDES, SparseTensor


def roi_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B, N, 7) boxes (cx, cy, cz, dx, dy, dz, yaw) -> (B, N, G^3, 3)
    global grid points."""
    b, n = rois.shape[:2]
    g = torch.arange(grid_size, dtype=rois.dtype, device=rois.device)
    gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
    dense_idx = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                            dim=-1)                                # (G3, 3)
    flat = rois.reshape(b * n, 7)
    local_size = flat[:, None, 3:6]
    pts = (dense_idx[None] + 0.5) / grid_size * local_size - local_size / 2
    pts = rotate_points_along_z(pts, flat[:, 6])
    return (pts + flat[:, None, 0:3]).reshape(b, n, -1, 3)


class NeighborVoxelPoolLayer(nn.Module):
    """One scale: mlp_in (+BN) on voxel features, neighbour grouping, the
    position MLP (3 -> C, +BN) on centre offsets, sum + ReLU, max
    (``max_pool``) or mean (``avg_pool``) over the neighbours, mlp_out (+BN,
    ReLU). ``cull_k > 0`` selects the culled query, 0 the dense one."""

    def __init__(self, cin: int, mlp_mid: int, mlp_out: int,
                 query_range: Tuple[int, int, int], radius: float,
                 nsample: int, voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float], stride: int,
                 cull_k: int, query_groups: int, *, device, generator,
                 pool_method: str = "max_pool",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if pool_method not in ("max_pool", "avg_pool"):
            raise ValueError(f"unknown pool_method {pool_method!r}")
        self.pool_method = pool_method
        self.query_range, self.radius, self.nsample = query_range, radius, \
            nsample
        self.voxel_size, self.point_cloud_range = voxel_size, \
            point_cloud_range
        self.stride, self.cull_k, self.query_groups = stride, cull_k, \
            query_groups
        kw = dict(bias=False, gain=KAIMING, device=device,
                  generator=generator)
        self.mlp_in = linear(cin, mlp_mid, **kw)
        bn = dict(device=device, momentum=0.99)
        self.mlp_in_bn = MaskedBatchNorm(mlp_mid, 1e-5, **bn)
        self.mlp_pos = linear(3, mlp_mid, **kw)
        self.mlp_pos_bn = MaskedBatchNorm(mlp_mid, 1e-5, **bn)
        self.mlp_out = linear(mlp_mid, mlp_out, **kw)
        self.mlp_out_bn = MaskedBatchNorm(mlp_out, 1e-5, **bn)

    def neighbours(self, st: SparseTensor, query_xyz: torch.Tensor,
                   query_valid: torch.Tensor):
        """The neighbour query of this scale: (rows (B, R, nsample) voxel
        rows of each query's neighbours in window scan order, the first
        repeated in unfilled slots and 0 where the query has none; empty
        (B, R); the voxel centres (B, M, 3))."""
        b = query_valid.shape[0]
        g3 = self.query_groups
        centers = get_voxel_centers(st.coords, self.stride, self.voxel_size,
                                    self.point_cloud_range)        # (B, M, 3)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32,
                          device=query_xyz.device)
        pc_min = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                              device=query_xyz.device)
        q_grid = torch.floor((query_xyz - pc_min) / vs).to(torch.int32) \
            // self.stride
        q_zyx = q_grid.flip(-1)
        if self.cull_k <= 0:
            rows, empty = voxel_query(
                centers, st.coords, st.valid, query_xyz, q_zyx, query_valid,
                self.query_range, self.radius, self.nsample)
            return rows, empty, centers
        cand, local, empty = voxel_query_boxed(
            centers, st.coords, st.valid, query_xyz.reshape(b, -1, g3, 3),
            q_zyx.reshape(b, -1, g3, 3), query_valid.reshape(b, -1, g3),
            self.query_range, self.radius, self.nsample, self.cull_k)
        # rows[b, q, s] = cand[b, q // g3, local[b, q, s]]
        rows = torch.gather(cand.repeat_interleave(g3, dim=1), 2, local)
        return rows, empty, centers

    def forward(self, st: SparseTensor, query_xyz: torch.Tensor,
                query_valid: torch.Tensor) -> torch.Tensor:
        """query_xyz (B, N * G3, 3) metric points, query_valid (B, N * G3)
        -> (B, N * G3, mlp_out)."""
        b = query_valid.shape[0]
        dt = self.dtype
        f = self.mlp_in_bn(dense(self.mlp_in, st.features, dt), st.valid)
        f = f * st.valid[..., None].to(f.dtype)
        rows, empty, centers = self.neighbours(st, query_xyz, query_valid)
        keep = ~empty
        grouped_f = neighbour_gather(f, rows, keep)                # (B,R,S,C)
        bidx = torch.arange(b, device=rows.device)[:, None, None]
        grouped_xyz = (centers[bidx, rows] - query_xyz[:, :, None]) \
            * keep[..., None, None].to(f.dtype)

        # empty-query rows (zeroed offsets) stay in the training statistics
        # across all S samples, as in the reference (roi_grid_pool.py:163)
        pos = self.mlp_pos_bn(dense(self.mlp_pos, grouped_xyz, dt),
                              query_valid[..., None])
        x = F.relu(grouped_f + pos)                                # (B,R,S,C)
        # amax splits the gradient evenly among tied maxima, as jnp.max does
        # (unfilled sample slots repeat the first neighbour)
        x = torch.amax(x, dim=2) if self.pool_method == "max_pool" \
            else torch.mean(x, dim=2)
        x = F.relu(self.mlp_out_bn(dense(self.mlp_out, x, dt), query_valid))
        return x * query_valid[..., None].to(x.dtype)


class ROIGridPool(nn.Module):
    """Multi-scale grid pooling (VoxelRCNNHead) and, with ``shared_fc``, its
    shared FC over each box's flattened grid: Linear (no bias, xavier
    normal) -> masked BatchNorm (eps 1e-5, momentum 0.99) -> ReLU per width
    of ``cfg.shared_fc``, Dropout(``cfg.dp_ratio``) between the layers.
    ``dtype``: the Dense layers' compute dtype."""

    def __init__(self, cfg, pc_cfg, shared_fc: bool = False, *, device,
                 generator, dtype: torch.dtype = torch.float32):
        """cfg: LiDARBackboneConfig, pc_cfg: PointCloudConfig."""
        super().__init__()
        self.dtype = dtype
        self.grid_size = cfg.grid_pool_size
        self.sources = [lc.source for lc in cfg.pool_layers]
        # the culled query only where it is asked for and not overridden by
        # the exact query (JAX: cull_k > 0 and not exact_query)
        cull_k = 0 if cfg.voxel_query_exact else max(cfg.pool_cull_k, 0)
        for lc in cfg.pool_layers:
            self.add_module(f"pool_{lc.source}", NeighborVoxelPoolLayer(
                BACKBONE_CHANNELS[lc.source], lc.mlps[0], lc.mlps[1],
                tuple(lc.query_range), lc.radius, lc.nsample,
                pc_cfg.voxel.voxel_size, pc_cfg.range,
                BACKBONE_STRIDES[lc.source], cull_k, self.grid_size ** 3,
                device=device, generator=generator,
                pool_method=lc.pool_method, dtype=dtype))
        self.shared_widths = tuple(cfg.shared_fc) if shared_fc else ()
        cin = self.grid_size ** 3 * sum(lc.mlps[1] for lc in cfg.pool_layers)
        for k, width in enumerate(self.shared_widths):
            # xavier normal: variance 2 / (fan_in + fan_out)
            self.add_module(f"shared_fc_{k}", linear(
                cin, width, bias=False, gain=2.0 * cin / (cin + width),
                device=device, generator=generator))
            self.add_module(f"shared_fc_bn_{k}", MaskedBatchNorm(
                width, 1e-5, device=device, momentum=0.99))
            cin = width
        self.dropout = Dropout(cfg.dp_ratio) \
            if len(self.shared_widths) > 1 and cfg.dp_ratio > 0 else None

    def forward(self, ms_features: Dict[str, SparseTensor],
                rois: torch.Tensor, roi_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """rois (B, N, 7), roi_valid (B, N) -> pooled (B, N, G^3,
        sum(mlp_out)) and the shared FC's (B, N, shared_fc[-1]) features,
        zero for padded boxes (None without ``shared_fc``)."""
        b, n = rois.shape[:2]
        g3 = self.grid_size ** 3
        grid_xyz = roi_grid_points(rois, self.grid_size).reshape(b, n * g3, 3)
        grid_valid = roi_valid.repeat_interleave(g3, dim=1)
        pooled = [getattr(self, f"pool_{src}")(ms_features[src], grid_xyz,
                                                grid_valid)
                  for src in self.sources]
        pooled = torch.cat(pooled, dim=-1)
        pooled = pooled.reshape(b, n, g3, pooled.shape[-1])
        if not self.shared_widths:
            return pooled, None
        x = pooled.reshape(b, n, -1)
        last = len(self.shared_widths) - 1
        for k in range(last + 1):
            x = dense(getattr(self, f"shared_fc_{k}"), x, self.dtype)
            x = F.relu(getattr(self, f"shared_fc_bn_{k}")(x, roi_valid))
            if k != last and self.dropout is not None:
                x = self.dropout(x)
        return pooled, x * roi_valid[..., None].to(x.dtype)
