"""Two-stage detectors (detection/roi_detectors.py): VoxelRCNN in detection
mode, and the shared two-stage machinery (the refinement MLP, stage-1
proposals, the two-stage loss and predict).

A dense anchor RPN proposes boxes; the proposals are NMS-selected, sampled
against the GT in training (roi_heads.py), pooled by the port's
multi-scale ROIGridPool (models/roi_grid_pool.py, without its shared FC)
and refined. Stage-1 outputs that feed the RoI path are detached, as the
reference's no-grad proposal and target layers are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import LiDARBackboneConfig, PointCloudConfig, VoxelizationConfig
from ..models.layers import BatchNorm, Dropout, linear
from ..models.roi_grid_pool import ROIGridPool
from .bev import cudnn_autotuned
from .box_coders import ResidualCoder
from .dense_heads import AnchorHeadSingle, anchor_head_loss, decode_anchor_preds
from .detectors import (DetBatch, DetectorConfig, VoxelDenseTrunk,
                        anchor_set_for, register_detector, _coder)
from .post import NMSConfig, post_processing
from .roi_heads import (RoISamplerConfig, canonical_gt_transform,
                        decode_roi_boxes, proposal_layer, roi_box_loss,
                        roi_cls_loss, sample_rois_for_rcnn)


@dataclasses.dataclass(frozen=True)
class RoIHeadConfig:
    num_rois_train: int = 128            # post-sampling RoIs per image
    shared_fc: Tuple[int, ...] = (256, 256)
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    dp_ratio: float = 0.3
    grid_size: int = 6
    sampler: RoISamplerConfig = RoISamplerConfig()
    train_nms: NMSConfig = NMSConfig(nms_thresh=0.8, nms_pre_maxsize=512,
                                     nms_post_maxsize=128, score_thresh=0.0)
    test_nms: NMSConfig = NMSConfig(nms_thresh=0.7, nms_pre_maxsize=256,
                                    nms_post_maxsize=100, score_thresh=0.0)
    rcnn_cls_weight: float = 1.0
    rcnn_reg_weight: float = 1.0
    rcnn_corner_weight: float = 1.0
    use_corner_loss: bool = True
    # PV-RCNN keypoint pooling (kept for the JAX config's fields)
    pool_radii: Tuple[float, ...] = (0.8, 1.6)
    pool_nsamples: Tuple[int, ...] = (16, 16)
    pool_mlps: Tuple[Tuple[int, ...], ...] = ((64, 64), (64, 64))
    # SECOND-IoU BEV pooling (kept for the JAX config's fields)
    bev_grid_size: int = 7
    bev_downsample: int = 8


class RefinementMLP(nn.Module):
    """Shared FC + cls / reg branches (roi_head_template.make_fc_layers):
    Linear (no bias, xavier normal) -> BatchNorm (eps 1e-3, momentum 0.99,
    masked by the valid RoIs in training) -> ReLU per width, with the
    port's seeded Dropout(dp_ratio) after every shared layer but the last
    and after each branch's first. Input (B, R, C); padded rows stay
    zero."""

    def __init__(self, cin: int, cfg: RoIHeadConfig, num_class: int = 1,
                 code_size: int = 7, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.stacks = {}
        kw = dict(device=device, generator=generator)
        shared = self._stack(cin, cfg.shared_fc, "shared_fc", **kw)
        self._stack(shared, cfg.cls_fc, "cls_fc", **kw)
        self._stack(shared, cfg.reg_fc, "reg_fc", **kw)
        self.cls_out = linear(cfg.cls_fc[-1] if cfg.cls_fc else shared,
                              num_class, **kw)
        reg_in = cfg.reg_fc[-1] if cfg.reg_fc else shared
        self.reg_out = linear(reg_in, code_size, **kw)
        with torch.no_grad():      # normal(0.001), as the JAX head draws it
            self.reg_out.weight.copy_(torch.randn(
                self.reg_out.weight.shape, generator=generator).to(device)
                * 0.001)
        self.dropout = Dropout(cfg.dp_ratio) if cfg.dp_ratio > 0 else None

    def _stack(self, cin, widths, name, *, device, generator) -> int:
        for k, w in enumerate(widths):
            # xavier normal: variance 2 / (fan_in + fan_out)
            self.add_module(f"{name}_{k}", linear(
                cin, w, bias=False, gain=2.0 * cin / (cin + w),
                device=device, generator=generator))
            self.add_module(f"{name}_{k}_bn", BatchNorm(
                w, 1e-3, device=device, momentum=0.99))
            cin = w
        self.stacks[name] = len(widths)
        return cin

    def _run(self, h, name, valid, dropout_first):
        n = self.stacks[name]
        for k in range(n):
            h = getattr(self, f"{name}_{k}")(h)
            h = F.relu(getattr(self, f"{name}_{k}_bn")(h, valid))
            drop = (k == 0) if dropout_first else (k != n - 1)
            if self.dropout is not None and drop:
                h = self.dropout(h)
        return h

    def forward(self, x: torch.Tensor, roi_valid: torch.Tensor):
        shared = self._run(x, "shared_fc", roi_valid, False)
        rcnn_cls = self.cls_out(self._run(shared, "cls_fc", roi_valid, True))
        rcnn_reg = self.reg_out(self._run(shared, "reg_fc", roi_valid, True))
        m = roi_valid[..., None].to(rcnn_reg.dtype)
        return rcnn_cls[..., 0] * m[..., 0], rcnn_reg * m


def _stage1_proposals(cfg: DetectorConfig, roi_cfg: RoIHeadConfig, preds,
                      batch: DetBatch, train: bool,
                      generator: Optional[torch.Generator]):
    """Decode the RPN -> NMS proposals -> (training) sampled RoIs and their
    targets."""
    cls, boxes = decode_anchor_preds(preds, anchor_set_for(cfg), _coder(cfg),
                                     cfg.head)
    nms_cfg = roi_cfg.train_nms if train else roi_cfg.test_nms
    rois, roi_scores, roi_labels, roi_valid = proposal_layer(
        cls.detach(), boxes.detach(), nms_cfg)
    out = {"rois": rois, "roi_scores": roi_scores, "roi_labels": roi_labels,
           "roi_valid": roi_valid}
    if train:
        items = [sample_rois_for_rcnn(
            generator, roi_cfg.sampler, rois[i], roi_scores[i],
            roi_labels[i], roi_valid[i], batch.gt_boxes[i],
            batch.gt_classes[i], batch.gt_valid[i])
            for i in range(rois.shape[0])]
        sampled = {k: torch.stack([it[k] for it in items]) for k in items[0]}
        out.update(sampled)
        out["gt_of_rois_ct"] = torch.stack([
            canonical_gt_transform(r, g) for r, g in
            zip(sampled["rois"], sampled["gt_of_rois"])])
    return out


def _two_stage_loss(cfg: DetectorConfig, roi_cfg: RoIHeadConfig, preds,
                    batch: DetBatch) -> Dict[str, torch.Tensor]:
    losses = anchor_head_loss(preds["rpn"], anchor_set_for(cfg), _coder(cfg),
                              cfg.head, batch.gt_boxes, batch.gt_classes,
                              batch.gt_valid)

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    cls_loss = roi_cls_loss(flat(preds["rcnn_cls"]),
                            flat(preds["rcnn_cls_labels"]),
                            roi_cfg.rcnn_cls_weight)
    reg = roi_box_loss(ResidualCoder(), flat(preds["rcnn_reg"]),
                       flat(preds["rois"]), flat(preds["gt_of_rois_ct"]),
                       flat(preds["gt_of_rois"]),
                       flat(preds["reg_valid_mask"]),
                       roi_cfg.rcnn_corner_weight, roi_cfg.rcnn_reg_weight,
                       roi_cfg.use_corner_loss)
    losses["rcnn_loss_cls"] = cls_loss
    losses.update({k: v for k, v in reg.items()
                   if k != "rcnn_loss_reg_total"})
    losses["loss"] = losses["rpn_loss"] + cls_loss \
        + reg["rcnn_loss_reg_total"]
    return losses


def _two_stage_predict(cfg: DetectorConfig, preds) -> Dict[str, torch.Tensor]:
    """Refined boxes + class-agnostic NMS; the labels come from the RoIs."""
    coder = ResidualCoder()
    b, r = preds["rcnn_cls"].shape
    boxes = decode_roi_boxes(coder, preds["rcnn_reg"].reshape(b * r, -1),
                             preds["rois"].reshape(b * r, -1)).reshape(
        b, r, -1)
    scores = torch.sigmoid(preds["rcnn_cls"]) \
        * preds["roi_valid"].to(torch.float32)
    return post_processing(scores[..., None], boxes, cfg.nms,
                           cls_preds_normalized=True,
                           valid=preds["roi_valid"],
                           labels=preds["roi_labels"])


class VoxelRCNNDetector(nn.Module):
    """VoxelRCNN in detection mode (voxel_rcnn.py + voxelrcnn_head.py,
    without the GT-RoI substitution): RPN proposals refined by the
    multi-scale voxel grid pool. The RoI sampler draws from ``generator``
    (``seed_sampler`` reseeds it per training step)."""

    def __init__(self, cfg: DetectorConfig,
                 roi_cfg: RoIHeadConfig = RoIHeadConfig(),
                 lidar_cfg: Optional[LiDARBackboneConfig] = None, *, device,
                 generator):
        super().__init__()
        self.cfg, self.roi_cfg = cfg, roi_cfg
        kw = dict(device=device, generator=generator)
        self.trunk = VoxelDenseTrunk(cfg, **kw)
        self.dense_head = AnchorHeadSingle(
            self.trunk.backbone_2d.num_bev_features, cfg.head,
            anchor_set_for(cfg).num_per_loc, _coder(cfg).full_code_size,
            **kw)
        pc = PointCloudConfig(
            range=tuple(cfg.point_cloud_range),
            voxel=VoxelizationConfig(voxel_size=tuple(cfg.voxel_size)))
        lidar_cfg = dataclasses.replace(
            lidar_cfg or LiDARBackboneConfig(),
            grid_pool_size=roi_cfg.grid_size, shared_fc=roi_cfg.shared_fc,
            dp_ratio=roi_cfg.dp_ratio,
            max_voxels_per_stage=cfg.max_voxels_per_stage)
        self.roi_grid_pool = ROIGridPool(lidar_cfg, pc, shared_fc=False, **kw)
        g3 = roi_cfg.grid_size ** 3
        cin = g3 * sum(lc.mlps[1] for lc in lidar_cfg.pool_layers)
        self.rcnn_head = RefinementMLP(cin, roi_cfg, **kw)
        self.sampler_generator = torch.Generator(device=device)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        with cudnn_autotuned():
            bev2d, ms = self.trunk(batch)
            rpn = self.dense_head(bev2d)
        stage1 = _stage1_proposals(self.cfg, self.roi_cfg, rpn, batch,
                                   self.training, self.sampler_generator)
        pooled, _ = self.roi_grid_pool(ms, stage1["rois"],
                                       stage1["roi_valid"])
        b, r = stage1["rois"].shape[:2]
        rcnn_cls, rcnn_reg = self.rcnn_head(pooled.reshape(b, r, -1),
                                            stage1["roi_valid"])
        return {"rpn": rpn, "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
                **stage1}

    def loss(self, preds, batch: DetBatch):
        return _two_stage_loss(self.cfg, self.roi_cfg, preds, batch)

    def predict(self, preds):
        return _two_stage_predict(self.cfg, preds)


@register_detector("VoxelRCNN-Det")
def _build_voxelrcnn_det(cfg, **kw):
    return VoxelRCNNDetector(cfg, **kw)
