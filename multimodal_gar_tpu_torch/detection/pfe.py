"""Point-feature extraction: keypoint sampling and voxel set abstraction
(detection/pfe.py; pcdet voxel_set_abstraction.py, VoxelSetAbstraction).

FPS keypoints from the raw points, then per source a multi-scale set
abstraction (StackSAModuleMSG: ball query -> relative xyz ++ features ->
shared MLP -> max over the samples) over the raw points, the backbone's
sparse voxel centres and the bilinearly sampled BEV map, fused by
Linear -> BN -> ReLU into PV-RCNN's keypoint features. Every function runs
batched over (B, ...); invalid supports are masked, not sliced.

The SA MLPs' BatchNorms take their training statistics over every row of
the batch, as pcdet's do. The JAX package calls the SA module under
``jax.vmap``, whose BatchNorms then normalise each item on its own and
leak their running statistics (ROADMAP Queue 3): at batch 1 the two agree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, linear
from ..models.sparse_backbone import SparseTensor
from ..ops.neighbor import ball_query, grouping_operation
from ..ops.sampling import farthest_point_sampling, gather_points
from ..ops.voxel import get_voxel_centers
from .point_heads import add_dense_stack, run_dense_stack


@dataclasses.dataclass(frozen=True)
class SALayerConfig:
    """One source's aggregation (SA_LAYER entries of the pv-rcnn configs)."""
    source: str = "raw_points"            # raw_points | x_conv1.. | bev
    downsample_factor: int = 1
    radii: Tuple[float, ...] = (0.4, 0.8)
    nsamples: Tuple[int, ...] = (16, 16)
    mlps: Tuple[Tuple[int, ...], ...] = ((16, 16), (16, 16))


@dataclasses.dataclass(frozen=True)
class VSAConfig:
    num_keypoints: int = 2048
    num_output_features: int = 128
    sa_layers: Tuple[SALayerConfig, ...] = (
        SALayerConfig("raw_points", 1, (0.4, 0.8), (16, 16),
                      ((16, 16), (16, 16))),
        SALayerConfig("x_conv1", 1, (0.4, 0.8), (16, 16),
                      ((16, 16), (16, 16))),
        SALayerConfig("x_conv2", 2, (0.8, 1.2), (16, 32),
                      ((32, 32), (32, 32))),
        SALayerConfig("x_conv3", 4, (1.2, 2.4), (16, 32),
                      ((64, 64), (64, 64))),
        SALayerConfig("x_conv4", 8, (2.4, 4.8), (16, 32),
                      ((64, 64), (64, 64))),
    )
    use_bev: bool = True
    bev_stride: int = 8


class StackSAModuleMSG(nn.Module):
    """Multi-scale grouping SA layer (pointnet2_stack StackSAModuleMSG):
    per (radius, nsample, mlp) a ball query around each query, (support
    xyz - query xyz) ++ support features through the shared MLP
    (``mlp{i}_{j}``), the max over the samples, zero for an empty ball;
    the scales concatenated. ``cin``: support feature channels."""

    def __init__(self, cin: int, radii, nsamples, mlps, *, device,
                 generator):
        super().__init__()
        self.radii, self.nsamples, self.mlps = radii, nsamples, mlps
        for i, mlp in enumerate(mlps):
            add_dense_stack(self, 3 + cin, mlp, f"mlp{i}", device=device,
                            generator=generator)

    @property
    def out_channels(self) -> int:
        return sum(m[-1] for m in self.mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                new_xyz: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """xyz (B, N, 3), features (B, N, C) or None, new_xyz (B, M, 3),
        valid (B, N) -> (B, M, sum of the last widths)."""
        outs = []
        for i, (r, ns, mlp) in enumerate(zip(self.radii, self.nsamples,
                                             self.mlps)):
            idx, empty = ball_query(r, ns, xyz, new_xyz, valid)
            grouped = grouping_operation(xyz, idx) - new_xyz[..., None, :]
            if features is not None:
                grouped = torch.cat(
                    [grouped, grouping_operation(features, idx)], -1)
            h = run_dense_stack(self, grouped, len(mlp), f"mlp{i}")
            # amax: the gradient of tied samples (a ball's repeated first
            # hit) is shared among them, as jnp.max's is
            h = torch.amax(h, dim=-2)
            outs.append(h * (~empty)[..., None].to(h.dtype))
        return torch.cat(outs, -1)


def bilinear_interpolate_bev(bev: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) map sampled at fractional (x, y) (B, K) -> (B, K, C)
    (voxel_set_abstraction.bilinear_interpolate_torch). The base cell is
    clamped to (w - 2, h - 2), so a query on the far edge interpolates the
    edge value instead of collapsing to four zero weights."""
    b, h, w, c = bev.shape
    x0 = torch.floor(x).long().clamp(0, w - 2)
    x1 = x0 + 1
    y0 = torch.floor(y).long().clamp(0, h - 2)
    y1 = y0 + 1
    xa = x.clamp(0, w - 1).to(bev.dtype)
    ya = y.clamp(0, h - 1).to(bev.dtype)
    wa = (x1 - xa) * (y1 - ya)
    wb = (x1 - xa) * (ya - y0)
    wc = (xa - x0) * (y1 - ya)
    wd = (xa - x0) * (ya - y0)
    flat = bev.reshape(b, h * w, c)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx)[..., None].expand(
            -1, -1, c))
    return (at(y0, x0) * wa[..., None] + at(y1, x0) * wb[..., None]
            + at(y0, x1) * wc[..., None] + at(y1, x1) * wd[..., None])


def bev_channels_last(bev: torch.Tensor) -> torch.Tensor:
    """The trunk's NCHW BEV map as (B, H, W, C)."""
    return bev.permute(0, 2, 3, 1)


class VoxelSetAbstraction(nn.Module):
    """FPS keypoints + multi-source aggregation + fusion (PV-RCNN's PFE).
    ``source_channels``: channels of each sparse source; ``point_features``
    the raw points' channels beyond xyz (a zero channel where none);
    ``bev_channels`` the BEV map's."""

    def __init__(self, cfg: VSAConfig, voxel_size, point_cloud_range,
                 source_channels: Dict[str, int], point_features: int,
                 bev_channels: int, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        kw = dict(device=device, generator=generator)
        craw = 0
        for sa in cfg.sa_layers:
            cin = (max(point_features, 1) if sa.source == "raw_points"
                   else source_channels[sa.source])
            mod = StackSAModuleMSG(cin, sa.radii, sa.nsamples, sa.mlps, **kw)
            self.add_module(f"sa_{sa.source}", mod)
            craw += mod.out_channels
        if cfg.use_bev:
            craw += bev_channels
        self.raw_channels = craw
        self.fusion = linear(craw, cfg.num_output_features, bias=False, **kw)
        self.fusion_bn = BatchNorm(cfg.num_output_features, 1e-3,
                                   device=device, momentum=0.99)

    def forward(self, points: torch.Tensor, point_valid: torch.Tensor,
                multi_scale: Dict[str, SparseTensor],
                bev: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """points (B, N, 3 + f), bev NCHW -> {"keypoints" (B, K, 3),
        "features" (B, K, F), "features_before_fusion" (B, K, Craw)}."""
        c = self.cfg
        xyz = points[..., :3]
        idx = farthest_point_sampling(xyz, c.num_keypoints, point_valid)
        keypoints = gather_points(xyz, idx)
        feats = []
        for sa_cfg in c.sa_layers:
            sa = getattr(self, f"sa_{sa_cfg.source}")
            if sa_cfg.source == "raw_points":
                pf = points[..., 3:] if points.shape[-1] > 3 \
                    else torch.zeros_like(points[..., :1])
                feats.append(sa(xyz, pf, keypoints, point_valid))
            else:
                st = multi_scale[sa_cfg.source]
                centers = get_voxel_centers(
                    st.coords, sa_cfg.downsample_factor, self.voxel_size,
                    self.point_cloud_range)
                feats.append(sa(centers, st.features, keypoints, st.valid))
        if c.use_bev and bev is not None:
            pr, vs = self.point_cloud_range, self.voxel_size
            x_idx = (keypoints[..., 0] - pr[0]) / (vs[0] * c.bev_stride)
            y_idx = (keypoints[..., 1] - pr[1]) / (vs[1] * c.bev_stride)
            feats.append(bilinear_interpolate_bev(bev_channels_last(bev),
                                                  x_idx, y_idx))
        raw = torch.cat(feats, -1)
        fused = F.relu(self.fusion_bn(self.fusion(raw)))
        return {"keypoints": keypoints, "features": fused,
                "features_before_fusion": raw}
