"""Part-A2: UNet part segmentation + RoI-aware part aggregation
(detection/parta2.py; pcdet PartA2_net.py, point_intra_part_head.py,
partA2_head.py).

UNetV2 (detection/sparse_backbones.py: its encoder, decoder and inverse
convs on the port's K3 / K4) gives per-voxel features at stride 1, from
which the point head predicts foreground and the intra-object part
location; the encoder's conv_out -> BEV -> RPN proposes boxes; the part
and seg features are pooled per RoI into a (G, G, G) grid
(ops/boxes3d.py: roiaware_pool3d, part by mean, seg by max), run through
dense 3x3x3 convs and a max pool (``F.conv3d`` / ``F.max_pool3d`` over
NCDHW grids: plain products outside any sparse kernel) and refined.

At ``DetectorConfig.dtype`` bfloat16 UNetV2 and conv_out compute in bf16
and the BEV map is rounded to bf16 before BaseBEVBackbone, as the JAX
module's (parta2.py:63-79); the point head, the RPN head, the RoI-aware
pooling, its dense conv stacks and the refinement stay float32 there, and
here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, draw, linear
from ..models.sparse_backbone import SparseTensor
from ..ops import boxes3d
from ..ops.device_rulebook import conv_out_shape, stage_shape
from ..ops.geometry import rotate_points_along_z
from ..ops.voxel import get_voxel_centers
from ..train import loss_lib
from .bev import cudnn_autotuned, sparse_to_dense_bev
from .dense_heads import AnchorHeadSingle
from .detectors import (CONV_OUT, DetBatch, DetectorConfig, SparseOutConv,
                        anchor_set_for, register_detector, _bev_backbone,
                        _check_dtype, _coder, _rounded)
from .point_heads import assign_point_targets
from .roi_detectors import (RefinementMLP, RoIHeadConfig, _stage1_proposals,
                            _two_stage_loss, _two_stage_predict)
from .sparse_backbones import UNetV2
from .vfe import mean_vfe


@dataclasses.dataclass(frozen=True)
class PartA2Config:
    pool_size: int = 12                  # reference uses 14; 12 keeps it light
    part_conv_channels: Tuple[int, ...] = (64, 64)
    seg_conv_channels: Tuple[int, ...] = (64, 64)


class Conv3d(nn.Module):
    """flax ``nn.Conv`` (3, 3, 3), SAME padding, no bias, over NCDHW;
    weight OIDHW, lecun normal as flax draws it."""

    def __init__(self, cin: int, cout: int, *, device, generator):
        super().__init__()
        self.weight = nn.Parameter(draw((cout, cin, 3, 3, 3),
                                        (1.0 / (27 * cin)) ** 0.5,
                                        device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, padding=1)


class PartA2Detector(nn.Module):
    """PartA2_net.py topology: UNetV2 -> {point part head, RPN} -> RoI-aware
    part pooling -> refinement. The RoI sampler draws from
    ``sampler_generator``."""

    def __init__(self, cfg: DetectorConfig,
                 roi_cfg: RoIHeadConfig = RoIHeadConfig(),
                 part_cfg: PartA2Config = PartA2Config(),
                 in_channels: int = 4, *, device, generator):
        super().__init__()
        self.dtype = _check_dtype(cfg)
        self.cfg, self.roi_cfg, self.part_cfg = cfg, roi_cfg, part_cfg
        kw = dict(device=device, generator=generator)
        self.backbone_3d = UNetV2(
            in_channels, x_window=cfg.x_window,
            max_voxels_per_stage=cfg.max_voxels_per_stage, dtype=self.dtype,
            **kw)
        self.seg_out = linear(16, 1, **kw)
        self.part_out = linear(16, 3, **kw)
        self.conv_out = SparseOutConv(
            64, 128, max_out_voxels=cfg.max_voxels_per_stage[3],
            dtype=self.dtype, **kw)
        shape = cfg.sparse_shape
        for k in (1, 2, 3):
            shape = stage_shape(shape, k)
        depth = conv_out_shape(shape, **CONV_OUT)[0]
        self.backbone_2d = _bev_backbone(cfg, depth * 128, **kw)
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, cfg.head,
            anchor_set_for(cfg).num_per_loc, _coder(cfg).full_code_size,
            **kw)
        for name, cin, chans in (("part_conv", 4, part_cfg.part_conv_channels),
                                 ("seg_conv", 16, part_cfg.seg_conv_channels)):
            for i, ch in enumerate(chans):
                self.add_module(f"{name}_{i}", Conv3d(cin, ch, **kw))
                self.add_module(f"{name}_{i}_bn", BatchNorm(
                    ch, 1e-3, device=device, momentum=0.99, channel_axis=1))
                cin = ch
        g = part_cfg.pool_size // 2
        merged = (part_cfg.part_conv_channels[-1]
                  + part_cfg.seg_conv_channels[-1]) * g ** 3
        self.rcnn_head = RefinementMLP(merged, roi_cfg, **kw)
        self.sampler_generator = torch.Generator(device=device)

    def _conv_stack(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        """Dense conv + BN + ReLU per width over (N, C, G, G, G), a 2^3 max
        pool after the first."""
        for i in range(n):
            x = F.relu(getattr(self, f"{name}_{i}_bn")(
                getattr(self, f"{name}_{i}")(x)))
            if i == 0:
                x = F.max_pool3d(x, 2, 2)
        return x

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        c = self.cfg
        feats = mean_vfe(batch.voxels, batch.voxel_num_points)
        feats = feats * batch.voxel_valid[..., None].to(feats.dtype)
        st = SparseTensor(feats, batch.voxel_coords, batch.voxel_valid,
                          c.sparse_shape)
        x_up1, ms = self.backbone_3d(st, batch.rulebook)
        # point-wise intra-part head (point_intra_part_head.py)
        seg_logits = self.seg_out(x_up1.features)[..., 0]
        part_reg = torch.sigmoid(self.part_out(x_up1.features))
        with cudnn_autotuned():
            bev = sparse_to_dense_bev(self.conv_out(ms["x_conv4"]))
            rpn = self.dense_head(self.backbone_2d(_rounded(bev,
                                                            self.dtype)))
        stage1 = _stage1_proposals(c, self.roi_cfg, rpn, batch,
                                   self.training, self.sampler_generator)
        # RoI-aware pooling (partA2_head: part by mean, seg by max)
        centers = get_voxel_centers(x_up1.coords, 1, c.voxel_size,
                                    c.point_cloud_range)
        parked = torch.where(x_up1.valid[..., None], centers, 1e6)
        part_feat = torch.cat([part_reg.detach(),
                               torch.sigmoid(seg_logits).detach()[..., None]],
                              -1)
        rois = stage1["rois"]
        g = self.part_cfg.pool_size
        part_p = boxes3d.roiaware_pool3d(parked, part_feat, rois, g, "avg")
        seg_p = boxes3d.roiaware_pool3d(parked, x_up1.features, rois, g,
                                        "max")
        b, r = rois.shape[:2]

        def ncdhw(x):
            return x.reshape((b * r, g, g, g, -1)).permute(0, 4, 1, 2, 3)
        with cudnn_autotuned():
            part_h = self._conv_stack(ncdhw(part_p), "part_conv",
                                      len(self.part_cfg.part_conv_channels))
            seg_h = self._conv_stack(ncdhw(seg_p), "seg_conv",
                                     len(self.part_cfg.seg_conv_channels))
        # channels last, as the flax stack's (B R, g, g, g, C) flattens
        merged = torch.cat([part_h, seg_h], 1).permute(0, 2, 3, 4, 1)
        rcnn_cls, rcnn_reg = self.rcnn_head(merged.reshape(b, r, -1),
                                            stage1["roi_valid"])
        return {"rpn": rpn, "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
                "seg_logits": seg_logits, "part_reg": part_reg,
                "voxel_centers": centers, "voxel_valid": x_up1.valid,
                **stage1}

    def loss(self, preds, batch: DetBatch, denominator=loss_lib.local_count
             ) -> Dict[str, torch.Tensor]:
        losses = _two_stage_loss(self.cfg, self.roi_cfg, preds, batch,
                                 denominator)
        # seg and part targets on the stride-1 voxel centres
        centers = preds["voxel_centers"]
        labels, gt_of, _ = assign_point_targets(
            centers, preds["voxel_valid"], batch.gt_boxes, batch.gt_classes,
            batch.gt_valid, extra_width=(0.2, 0.2, 0.2))
        fg = labels > 0
        one = fg.to(torch.float32)
        w = (labels >= 0).to(torch.float32)
        w = w / fg.sum(-1, keepdim=True).to(torch.float32).clamp(min=1.0)
        seg_loss = loss_lib.sigmoid_focal_loss(
            preds["seg_logits"][..., None], one[..., None], w).sum() \
            / labels.shape[0]
        # intra-part targets: the canonical in-box position in [0, 1]^3
        b, n = centers.shape[:2]
        local = rotate_points_along_z(
            (centers - gt_of[..., :3]).reshape(b * n, 1, 3),
            -gt_of[..., 6].reshape(b * n))[:, 0].reshape(b, n, 3)
        part_t = torch.clamp(local / gt_of[..., 3:6].clamp(min=1e-5) + 0.5,
                             0.0, 1.0)
        pr = preds["part_reg"]
        bce = -(part_t * torch.log(pr.clamp(1e-7, 1.0))
                + (1 - part_t) * torch.log((1 - pr).clamp(1e-7, 1.0)))
        part_loss = (bce.sum(-1) * fg).sum() \
            / denominator(fg.sum().to(torch.float32))
        losses["point_loss_seg"] = seg_loss
        losses["point_loss_part"] = part_loss
        losses["loss"] = losses["loss"] + seg_loss + part_loss
        return losses

    def predict(self, preds):
        return _two_stage_predict(self.cfg, preds)


@register_detector("PartA2Net")
@register_detector("PartA2")
def _build_parta2(cfg, **kw):
    return PartA2Detector(cfg, **kw)
