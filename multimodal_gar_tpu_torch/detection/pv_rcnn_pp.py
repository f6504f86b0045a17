"""PV-RCNN++: proposal-centric keypoints + vector-pool aggregation
(detection/pv_rcnn_pp.py; pcdet pv_rcnn_plusplus.py and the PV-RCNN++
parts of voxel_set_abstraction.py: sample_points_with_roi, sector_fps, and
the VectorPoolAggregation modules).

Proposals come first; the keypoints are sampled by FPS per azimuth sector
from the points near a proposal; every local aggregation is a vector pool
(ops/vector_pool.py) instead of a ball-query MSG. The proposal filter is a
mask (points outside keep their slot, marked invalid); each sector gets a
fixed quota and all sectors of all items run in one batched FPS.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, linear
from ..models.roi_grid_pool import roi_grid_points
from ..models.sparse_backbone import BACKBONE_CHANNELS
from ..ops.sampling import farthest_point_sampling, gather_points
from ..ops.vector_pool import vector_pool
from ..ops.voxel import get_voxel_centers
from ..train.loss_lib import local_count
from .bev import cudnn_autotuned
from .dense_heads import AnchorHeadSingle
from .detectors import (DetBatch, DetectorConfig, VoxelDenseTrunk,
                        anchor_set_for, register_detector, _coder)
from .pfe import bev_channels_last, bilinear_interpolate_bev
from .point_heads import PointHeadConfig, PointHeadSimple
from .roi_detectors import (RefinementMLP, RoIHeadConfig, _stage1_proposals,
                            _two_stage_loss, _two_stage_predict,
                            keypoint_loss)


@dataclasses.dataclass(frozen=True)
class PVPPConfig:
    num_keypoints: int = 2048
    num_sectors: int = 6
    sample_radius_with_roi: float = 1.6
    num_output_features: int = 90
    vp_grid_size: int = 3
    vp_radii: Tuple[float, ...] = (0.8, 1.6)     # raw-point scales
    vp_mlp: int = 32
    vsa_sources: Tuple[Tuple[str, int, float], ...] = (
        ("x_conv3", 4, 1.2), ("x_conv4", 8, 2.4))
    use_bev: bool = True
    bev_stride: int = 8


class VectorPoolLocalAgg(nn.Module):
    """VectorPoolAggregation at one scale: the sub-voxel means of the
    vector pool -> a per-cell Linear + ReLU (empty cells zero) -> the cells
    concatenated -> Linear (separate_local_agg with a g^3 dense grid)."""

    def __init__(self, cin: int, out_channels: int, radius: float,
                 grid_size: int = 3, *, device, generator):
        super().__init__()
        self.radius, self.grid_size = radius, grid_size
        kw = dict(device=device, generator=generator)
        self.cell_mlp = linear(3 + cin, out_channels, **kw)
        self.merge = linear(grid_size ** 3 * out_channels, out_channels,
                            **kw)

    def forward(self, support_xyz, support_feats, support_valid, query_xyz):
        pooled, counts = vector_pool(support_xyz, support_feats,
                                     support_valid, query_xyz, self.radius,
                                     self.grid_size)        # (B, M, G3, 3+C)
        h = F.relu(self.cell_mlp(pooled)) \
            * (counts > 0)[..., None].to(pooled.dtype)
        return self.merge(h.reshape(h.shape[:-2] + (-1,)))


def sector_fps(points: torch.Tensor, valid: torch.Tensor, num_keypoints: int,
               num_sectors: int) -> torch.Tensor:
    """Sectorized FPS (voxel_set_abstraction.sector_fps): the points split
    by azimuth, a fixed quota K / S sampled by FPS in each sector, all
    sectors of all items in one FPS. points (B, N, 3+), valid (B, N) ->
    (B, S * quota, 3)."""
    quota = num_keypoints // num_sectors
    angle = torch.atan2(points[..., 1], points[..., 0]) + math.pi
    sector = torch.clamp((angle / (2 * math.pi / num_sectors)).to(
        torch.int32), 0, num_sectors - 1)
    s = torch.arange(num_sectors, device=points.device)
    mask = valid[:, None, :] & (sector[:, None, :] == s[None, :, None])
    xyz = points[:, None, :, :3].expand(-1, num_sectors, -1, -1)
    idx = farthest_point_sampling(xyz, quota, mask)          # (B, S, quota)
    return gather_points(xyz, idx).reshape(points.shape[0], -1, 3)


def sample_points_with_roi(points: torch.Tensor, valid: torch.Tensor,
                           rois: torch.Tensor, roi_valid: torch.Tensor,
                           sample_radius: float) -> torch.Tensor:
    """The valid points within (RoI half diagonal + sample_radius) of some
    valid RoI's centre (voxel_set_abstraction.sample_points_with_roi).
    points (B, N, 3+), rois (B, R, 7) -> (B, N) bool."""
    d2 = ((points[..., :, None, :3] - rois[..., None, :, :3]) ** 2).sum(-1)
    roi_r = torch.linalg.vector_norm(rois[..., 3:6], dim=-1) / 2.0 \
        + sample_radius
    near = (d2 <= (roi_r ** 2)[..., None, :]) & roi_valid[..., None, :]
    return valid & near.any(-1)


class PVRCNNPlusPlusDetector(nn.Module):
    """pv_rcnn_plusplus.py topology: RPN -> proposals -> sectorized
    proposal-centric keypoints -> vector-pool VSA -> vector-pool RoI grid
    pooling -> refinement. The RoI sampler draws from
    ``sampler_generator``."""

    def __init__(self, cfg: DetectorConfig,
                 roi_cfg: RoIHeadConfig = RoIHeadConfig(),
                 pp_cfg: PVPPConfig = PVPPConfig(), in_channels: int = 4, *,
                 device, generator):
        super().__init__()
        self.cfg, self.roi_cfg, self.pp_cfg = cfg, roi_cfg, pp_cfg
        kw = dict(device=device, generator=generator)
        self.trunk = VoxelDenseTrunk(cfg, in_channels, **kw)
        bev_ch = self.trunk.backbone_2d.num_bev_features
        self.dense_head = AnchorHeadSingle(
            bev_ch, cfg.head, anchor_set_for(cfg).num_per_loc,
            _coder(cfg).full_code_size, **kw)
        pp = pp_cfg
        pf = max(in_channels - 3, 1)
        for i, r in enumerate(pp.vp_radii):
            self.add_module(f"vp_raw_{i}", VectorPoolLocalAgg(
                pf, pp.vp_mlp, r, pp.vp_grid_size, **kw))
        for src, _, r in pp.vsa_sources:
            self.add_module(f"vp_{src}", VectorPoolLocalAgg(
                BACKBONE_CHANNELS[src], pp.vp_mlp, r, pp.vp_grid_size, **kw))
        raw = pp.vp_mlp * (len(pp.vp_radii) + len(pp.vsa_sources)) \
            + (bev_ch if pp.use_bev else 0)
        self.fusion = linear(raw, pp.num_output_features, bias=False, **kw)
        self.fusion_bn = BatchNorm(pp.num_output_features, 1e-3,
                                   device=device, momentum=0.99)
        self.point_head = PointHeadSimple(
            raw, PointHeadConfig(num_class=1, class_agnostic=True), **kw)
        self.vp_roi = VectorPoolLocalAgg(
            pp.num_output_features, pp.vp_mlp * 2, roi_cfg.pool_radii[-1],
            pp.vp_grid_size, **kw)
        self.rcnn_head = RefinementMLP(
            roi_cfg.grid_size ** 3 * pp.vp_mlp * 2, roi_cfg, **kw)
        self.sampler_generator = torch.Generator(device=device)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        c, pp = self.cfg, self.pp_cfg
        if batch.points is None:
            raise ValueError("PV-RCNN++ needs the raw points "
                             "(DetBatch.points)")
        with cudnn_autotuned():
            bev2d, ms = self.trunk(batch)
            rpn = self.dense_head(bev2d)
        stage1 = _stage1_proposals(c, self.roi_cfg, rpn, batch,
                                   self.training, self.sampler_generator)
        pts, pv = batch.points, batch.point_valid
        with torch.no_grad():
            near = sample_points_with_roi(pts, pv, stage1["rois"],
                                          stage1["roi_valid"],
                                          pp.sample_radius_with_roi)
            # all valid points where none is near a proposal
            use = torch.where(near.any(-1, keepdim=True), near, pv)
            keypoints = sector_fps(pts, use, pp.num_keypoints,
                                   pp.num_sectors)
        xyz = pts[..., :3]
        pf = pts[..., 3:] if pts.shape[-1] > 3 else torch.zeros_like(
            pts[..., :1])
        feats = [getattr(self, f"vp_raw_{i}")(xyz, pf, pv, keypoints)
                 for i in range(len(pp.vp_radii))]
        for src, stride, _ in pp.vsa_sources:
            st = ms[src]
            centers = get_voxel_centers(st.coords, stride, c.voxel_size,
                                        c.point_cloud_range)
            feats.append(getattr(self, f"vp_{src}")(centers, st.features,
                                                    st.valid, keypoints))
        if pp.use_bev:
            x_idx = (keypoints[..., 0] - c.point_cloud_range[0]) \
                / (c.voxel_size[0] * pp.bev_stride)
            y_idx = (keypoints[..., 1] - c.point_cloud_range[1]) \
                / (c.voxel_size[1] * pp.bev_stride)
            feats.append(bilinear_interpolate_bev(bev_channels_last(bev2d),
                                                  x_idx, y_idx))
        raw = torch.cat(feats, -1)
        kp_feats = F.relu(self.fusion_bn(self.fusion(raw)))
        ph = self.point_head(raw)
        kp_feats = kp_feats * ph["point_cls_scores"].detach()[..., None]
        b, r = stage1["rois"].shape[:2]
        grid = roi_grid_points(stage1["rois"], self.roi_cfg.grid_size)
        pooled = self.vp_roi(keypoints, kp_feats,
                             torch.ones(keypoints.shape[:2], dtype=torch.bool,
                                        device=keypoints.device),
                             grid.reshape(b, -1, 3))
        rcnn_cls, rcnn_reg = self.rcnn_head(pooled.reshape(b, r, -1),
                                            stage1["roi_valid"])
        return {"rpn": rpn, "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
                "point_cls_preds": ph["point_cls_preds"],
                "keypoints": keypoints, **stage1}

    def loss(self, preds, batch: DetBatch, denominator=local_count):
        return keypoint_loss(
            _two_stage_loss(self.cfg, self.roi_cfg, preds, batch,
                            denominator), preds, batch)

    def predict(self, preds):
        return _two_stage_predict(self.cfg, preds)


@register_detector("PVRCNNPlusPlus")
@register_detector("PV-RCNN++")
def _build_pvrcnn_pp(cfg, **kw):
    return PVRCNNPlusPlusDetector(cfg, **kw)
