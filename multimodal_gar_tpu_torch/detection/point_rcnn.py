"""PointRCNN: the point-based two-stage detector (detection/point_rcnn.py;
pcdet point_rcnn.py + roi_heads/pointrcnn_head.py).

PointNet++ over the raw points, PointHeadBox as the first stage (a class
and a box per point, NMS into proposals), RoI-point pooling
(ops/boxes3d.py: roipoint_pool3d, the first K in-box points per RoI) with
the canonical transform, the xyz-up / merge-down fusion, a set-abstraction
encoder per RoI over (B R, K) points with batched FPS, and the cls / reg
refinement. Empty RoIs are masked.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..ops.boxes3d import roipoint_pool3d
from ..ops.geometry import rotate_points_along_z, safe_sqrt
from ..train.loss_lib import local_count
from .box_coders import PointResidualCoder, ResidualCoder
from .detectors import DetBatch, DetectorConfig, register_detector
from .point_heads import (PointHeadBox, PointHeadConfig, add_dense_stack,
                          assign_point_targets, point_box_loss,
                          point_cls_loss, run_dense_stack)
from .pointnet2 import PointNet2Config, PointNet2MSG, SAModuleMSG
from .roi_detectors import (RefinementMLP, RoIHeadConfig, _two_stage_predict,
                            sample_stage1)
from .roi_heads import proposal_layer, roi_box_loss, roi_cls_loss


@dataclasses.dataclass(frozen=True)
class PointRCNNRoIConfig:
    num_sampled_points: int = 512
    depth_normalizer: float = 70.0
    xyz_up_layer: Tuple[int, ...] = (128, 128)
    sa_npoints: Tuple[int, ...] = (128, 32, -1)
    sa_radii: Tuple[float, ...] = (0.2, 0.4, 100.0)
    sa_nsamples: Tuple[int, ...] = (16, 16, 16)
    sa_mlps: Tuple[Tuple[int, ...], ...] = ((128, 128, 128),
                                            (128, 128, 256),
                                            (256, 256, 512))


class PointRCNNDetector(nn.Module):
    """point_rcnn.py topology: PointNet2MSG -> PointHeadBox ->
    PointRCNNHead. The RoI sampler draws from ``sampler_generator``."""

    def __init__(self, cfg: DetectorConfig,
                 roi_cfg: RoIHeadConfig = RoIHeadConfig(use_corner_loss=True),
                 pn2_cfg: PointNet2Config = PointNet2Config(),
                 pool_cfg: PointRCNNRoIConfig = PointRCNNRoIConfig(),
                 in_channels: int = 4, *, device, generator):
        super().__init__()
        self.cfg, self.roi_cfg, self.pool_cfg = cfg, roi_cfg, pool_cfg
        self.point_head_cfg = PointHeadConfig(num_class=len(cfg.class_names))
        self.coder = PointResidualCoder()
        kw = dict(device=device, generator=generator)
        self.backbone_3d = PointNet2MSG(pn2_cfg, in_channels - 3, **kw)
        feat = self.backbone_3d.out_channels
        self.point_head = PointHeadBox(feat, self.point_head_cfg, self.coder,
                                       **kw)
        up = add_dense_stack(self, 5, pool_cfg.xyz_up_layer, "xyz_up", **kw)
        cur = add_dense_stack(self, up + feat, (up,), "merge_down", **kw)
        for i, (np_, rad, ns, mlp) in enumerate(zip(
                pool_cfg.sa_npoints, pool_cfg.sa_radii, pool_cfg.sa_nsamples,
                pool_cfg.sa_mlps)):
            if np_ == -1:
                cur = add_dense_stack(self, 3 + cur, mlp, f"sa{i}_global",
                                      **kw)
                break
            self.add_module(f"sa{i}", SAModuleMSG(cur, np_, (rad,), (ns,),
                                                  (mlp,), **kw))
            cur = mlp[-1]
        self.rcnn_head = RefinementMLP(cur, roi_cfg, **kw)
        self.sampler_generator = torch.Generator(device=device)

    def _roi_features(self, xyz, feats, scores, rois):
        """RoI-point pooling, the canonical transform, the fusion and the
        per-RoI SA encoder (pointrcnn_head.py:85-179) -> ((B, R, C), empty
        (B, R))."""
        pc = self.pool_cfg
        depth = safe_sqrt((xyz ** 2).sum(-1)) / pc.depth_normalizer - 0.5
        pfeat = torch.cat([scores[..., None], depth[..., None], feats], -1)
        pooled, empty = roipoint_pool3d(xyz, pfeat, rois,
                                        pc.num_sampled_points)
        b, r, k, _ = pooled.shape
        rois_flat = rois.reshape(b * r, 7)
        pooled = pooled.reshape(b * r, k, -1)
        local_xyz = rotate_points_along_z(
            pooled[..., :3] - rois_flat[:, None, :3], -rois_flat[:, 6])
        prefix = torch.cat([local_xyz, pooled[..., 3:5]], -1)  # xyz, s, d
        up = run_dense_stack(self, prefix, len(pc.xyz_up_layer), "xyz_up")
        cur_f = run_dense_stack(self, torch.cat([up, pooled[..., 5:]], -1),
                                1, "merge_down")
        cur_xyz = local_xyz
        cur_valid = (~empty).reshape(b * r, 1).expand(b * r, k)
        for i, (np_, mlp) in enumerate(zip(pc.sa_npoints, pc.sa_mlps)):
            if np_ == -1:                           # global pool
                h = run_dense_stack(self, torch.cat([cur_xyz, cur_f], -1),
                                    len(mlp), f"sa{i}_global")
                h = torch.amax(torch.where(cur_valid[..., None], h,
                                           -torch.inf), dim=1)
                cur_f = torch.where(cur_valid.any(1)[..., None], h, 0.0)
                break
            cur_xyz, cur_f, cur_valid = getattr(self, f"sa{i}")(
                cur_xyz, cur_f, cur_valid)
        return cur_f.reshape(b, r, -1), empty

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        if batch.points is None:
            raise ValueError("PointRCNN needs the raw points (DetBatch.points)")
        xyz = batch.points[..., :3]
        feats = self.backbone_3d(batch.points, batch.point_valid)
        ph = self.point_head(feats)
        # a box per point -> proposals (point_head_box.py:82-96)
        pred_cls = ph["point_cls_preds"].argmax(-1) + 1
        point_boxes = self.coder.decode(ph["point_box_preds"], xyz, pred_cls)
        cls_for_nms = torch.where(batch.point_valid[..., None],
                                  ph["point_cls_preds"], -1e4)
        nms_cfg = (self.roi_cfg.train_nms if self.training
                   else self.roi_cfg.test_nms)
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            cls_for_nms.detach(), point_boxes.detach(), nms_cfg)
        stage1 = {"rois": rois, "roi_scores": roi_scores,
                  "roi_labels": roi_labels, "roi_valid": roi_valid}
        if self.training:
            stage1 = sample_stage1(self.roi_cfg, stage1, batch,
                                   self.sampler_generator)
        roi_feats, empty = self._roi_features(
            xyz, feats.detach(), ph["point_cls_scores"].detach(),
            stage1["rois"])
        rcnn_cls, rcnn_reg = self.rcnn_head(roi_feats,
                                            stage1["roi_valid"] & ~empty)
        return {"point_cls_preds": ph["point_cls_preds"],
                "point_box_preds": ph["point_box_preds"],
                "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg, **stage1}

    def loss(self, preds, batch: DetBatch, denominator=local_count
             ) -> Dict[str, torch.Tensor]:
        xyz = batch.points[..., :3]
        labels, gt_of_pts, _ = assign_point_targets(
            xyz, batch.point_valid, batch.gt_boxes, batch.gt_classes,
            batch.gt_valid, extra_width=self.point_head_cfg.gt_extra_width)
        losses = {
            "point_loss_cls": point_cls_loss(preds["point_cls_preds"], labels,
                                             self.point_head_cfg.num_class),
            "point_loss_box": point_box_loss(self.coder,
                                             preds["point_box_preds"], xyz,
                                             labels, gt_of_pts)}

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))
        losses["rcnn_loss_cls"] = roi_cls_loss(
            flat(preds["rcnn_cls"]), flat(preds["rcnn_cls_labels"]),
            self.roi_cfg.rcnn_cls_weight, denominator)
        reg = roi_box_loss(ResidualCoder(), flat(preds["rcnn_reg"]),
                           flat(preds["rois"]), flat(preds["gt_of_rois_ct"]),
                           flat(preds["gt_of_rois"]),
                           flat(preds["reg_valid_mask"]),
                           self.roi_cfg.rcnn_corner_weight,
                           self.roi_cfg.rcnn_reg_weight,
                           self.roi_cfg.use_corner_loss, denominator)
        losses.update({k: v for k, v in reg.items()
                       if k != "rcnn_loss_reg_total"})
        losses["loss"] = losses["point_loss_cls"] + losses["point_loss_box"] \
            + losses["rcnn_loss_cls"] + reg["rcnn_loss_reg_total"]
        return losses

    def predict(self, preds) -> Dict[str, torch.Tensor]:
        return _two_stage_predict(self.cfg, preds)


@register_detector("PointRCNN")
def _build_pointrcnn(cfg, **kw):
    return PointRCNNDetector(cfg, **kw)
