"""Two-stage detectors (detection/roi_detectors.py): VoxelRCNN in detection
mode, PV-RCNN and SECOND-IoU, and the shared two-stage machinery (the
refinement MLP, stage-1 proposals, the two-stage loss and predict).

A dense anchor RPN proposes boxes; the proposals are NMS-selected, sampled
against the GT in training (roi_heads.py), pooled and refined: by the
port's multi-scale ROIGridPool (models/roi_grid_pool.py, without its shared
FC) for VoxelRCNN, by set abstraction over the keypoints for PV-RCNN
(pvrcnn_head.py), by a rotated BEV grid for SECOND-IoU (second_head.py).
Stage-1 outputs that feed the RoI path are detached, as the reference's
no-grad proposal and target layers are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import LiDARBackboneConfig, PointCloudConfig, VoxelizationConfig
from ..models.layers import BatchNorm, Dropout, linear
from ..models.roi_grid_pool import ROIGridPool, roi_grid_points
from ..models.sparse_backbone import BACKBONE_CHANNELS
from .bev import cudnn_autotuned
from .box_coders import ResidualCoder
from .dense_heads import AnchorHeadSingle, anchor_head_loss, decode_anchor_preds
from .detectors import (DetBatch, DetectorConfig, VoxelDenseTrunk,
                        anchor_set_for, register_detector, _coder)
from .pfe import (StackSAModuleMSG, VoxelSetAbstraction, VSAConfig,
                  bev_channels_last, bilinear_interpolate_bev)
from .point_heads import (PointHeadConfig, PointHeadSimple,
                          assign_point_targets, point_cls_loss)
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
    # PV-RCNN keypoint pooling
    pool_radii: Tuple[float, ...] = (0.8, 1.6)
    pool_nsamples: Tuple[int, ...] = (16, 16)
    pool_mlps: Tuple[Tuple[int, ...], ...] = ((64, 64), (64, 64))
    # SECOND-IoU BEV pooling
    bev_grid_size: int = 7
    bev_downsample: int = 8


class RefinementMLP(nn.Module):
    """Shared FC + cls / reg branches (roi_head_template.make_fc_layers):
    Linear (no bias, xavier normal) -> BatchNorm (eps 1e-3, momentum 0.99,
    masked by the valid RoIs in training) -> ReLU per width, with the
    port's seeded Dropout(dp_ratio) after every shared layer but the last
    and after each branch's first. Input (B, R, C); padded rows stay
    zero. ``iou_head`` (SECOND-IoU): the cls branch alone, its one output
    not masked, and no regression."""

    def __init__(self, cin: int, cfg: RoIHeadConfig, num_class: int = 1,
                 code_size: int = 7, iou_head: bool = False, *, device,
                 generator):
        super().__init__()
        self.cfg = cfg
        self.iou_head = iou_head
        self.stacks = {}
        kw = dict(device=device, generator=generator)
        shared = self._stack(cin, cfg.shared_fc, "shared_fc", **kw)
        self._stack(shared, cfg.cls_fc, "cls_fc", **kw)
        if not iou_head:
            self._stack(shared, cfg.reg_fc, "reg_fc", **kw)
        self.cls_out = linear(cfg.cls_fc[-1] if cfg.cls_fc else shared,
                              num_class, **kw)
        self.dropout = Dropout(cfg.dp_ratio) if cfg.dp_ratio > 0 else None
        if iou_head:
            return
        reg_in = cfg.reg_fc[-1] if cfg.reg_fc else shared
        self.reg_out = linear(reg_in, code_size, **kw)
        with torch.no_grad():      # normal(0.001), as the JAX head draws it
            self.reg_out.weight.copy_(torch.randn(
                self.reg_out.weight.shape, generator=generator).to(device)
                * 0.001)

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
        if self.iou_head:
            return rcnn_cls[..., 0], None
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
    return sample_stage1(roi_cfg, out, batch, generator) if train else out


def sample_stage1(roi_cfg: RoIHeadConfig, out: Dict[str, torch.Tensor],
                  batch: DetBatch, generator: Optional[torch.Generator]
                  ) -> Dict[str, torch.Tensor]:
    """The training half of the stage-1 path: the proposals in ``out``
    sampled against the GT per item (roi_heads.py: sample_rois_for_rcnn,
    which replaces rois / roi_valid / roi_labels) and their canonical GT
    targets."""
    rois, roi_scores = out["rois"], out["roi_scores"]
    roi_labels, roi_valid = out["roi_labels"], out["roi_valid"]
    items = [sample_rois_for_rcnn(
        generator, roi_cfg.sampler, rois[i], roi_scores[i], roi_labels[i],
        roi_valid[i], batch.gt_boxes[i], batch.gt_classes[i],
        batch.gt_valid[i]) for i in range(rois.shape[0])]
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
                 lidar_cfg: Optional[LiDARBackboneConfig] = None,
                 in_channels: int = 4, *, device, generator):
        super().__init__()
        self.cfg, self.roi_cfg = cfg, roi_cfg
        kw = dict(device=device, generator=generator)
        self.trunk = VoxelDenseTrunk(cfg, in_channels, **kw)
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


class PVRCNNDetector(nn.Module):
    """PV-RCNN (pv_rcnn.py): voxel trunk + VoxelSetAbstraction keypoints +
    PointHeadSimple keypoint weighting + RoI grid pooling by set
    abstraction over the keypoints (pvrcnn_head.py). The RoI sampler draws
    from ``sampler_generator``."""

    def __init__(self, cfg: DetectorConfig,
                 roi_cfg: RoIHeadConfig = RoIHeadConfig(),
                 vsa_cfg: VSAConfig = VSAConfig(), in_channels: int = 4, *,
                 device, generator):
        super().__init__()
        self.cfg, self.roi_cfg = cfg, roi_cfg
        kw = dict(device=device, generator=generator)
        self.trunk = VoxelDenseTrunk(cfg, in_channels, **kw)
        bev_ch = self.trunk.backbone_2d.num_bev_features
        self.dense_head = AnchorHeadSingle(
            bev_ch, cfg.head, anchor_set_for(cfg).num_per_loc,
            _coder(cfg).full_code_size, **kw)
        self.pfe = VoxelSetAbstraction(
            vsa_cfg, cfg.voxel_size, cfg.point_cloud_range,
            BACKBONE_CHANNELS, in_channels - 3, bev_ch, **kw)
        self.point_head = PointHeadSimple(
            self.pfe.raw_channels,
            PointHeadConfig(num_class=1, class_agnostic=True), **kw)
        self.roi_grid_pool = StackSAModuleMSG(
            vsa_cfg.num_output_features,
            roi_cfg.pool_radii, roi_cfg.pool_nsamples, roi_cfg.pool_mlps,
            **kw)
        self.rcnn_head = RefinementMLP(
            roi_cfg.grid_size ** 3 * self.roi_grid_pool.out_channels,
            roi_cfg, **kw)
        self.sampler_generator = torch.Generator(device=device)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        if batch.points is None:
            raise ValueError("PV-RCNN needs the raw points (DetBatch.points)")
        with cudnn_autotuned():
            bev2d, ms = self.trunk(batch)
            rpn = self.dense_head(bev2d)
        vsa = self.pfe(batch.points, batch.point_valid, ms, bev2d)
        ph = self.point_head(vsa["features_before_fusion"])
        stage1 = _stage1_proposals(self.cfg, self.roi_cfg, rpn, batch,
                                   self.training, self.sampler_generator)
        # keypoint features weighted by the foreground score (pvrcnn_head:82)
        kp_feats = vsa["features"] \
            * ph["point_cls_scores"].detach()[..., None]
        b, r = stage1["rois"].shape[:2]
        grid = roi_grid_points(stage1["rois"], self.roi_cfg.grid_size)
        pooled = self.roi_grid_pool(vsa["keypoints"], kp_feats,
                                    grid.reshape(b, -1, 3))
        rcnn_cls, rcnn_reg = self.rcnn_head(pooled.reshape(b, r, -1),
                                            stage1["roi_valid"])
        return {"rpn": rpn, "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
                "point_cls_preds": ph["point_cls_preds"],
                "keypoints": vsa["keypoints"], **stage1}

    def loss(self, preds, batch: DetBatch):
        return keypoint_loss(
            _two_stage_loss(self.cfg, self.roi_cfg, preds, batch), preds,
            batch)

    def predict(self, preds):
        return _two_stage_predict(self.cfg, preds)


def keypoint_loss(losses: Dict[str, torch.Tensor], preds,
                  batch: DetBatch) -> Dict[str, torch.Tensor]:
    """The keypoint segmentation loss of PV-RCNN and PV-RCNN++ added to
    ``losses``: keypoints labelled by the GT boxes (0.2 m ignore ring)."""
    kp = preds["keypoints"]
    labels, _, _ = assign_point_targets(
        kp, torch.ones(kp.shape[:2], dtype=torch.bool, device=kp.device),
        batch.gt_boxes, batch.gt_classes, batch.gt_valid,
        extra_width=(0.2, 0.2, 0.2))
    losses["point_loss_cls"] = point_cls_loss(preds["point_cls_preds"],
                                              labels, 1)
    losses["loss"] = losses["loss"] + losses["point_loss_cls"]
    return losses


class SECONDIoUDetector(nn.Module):
    """SECOND-IoU (second_net_iou.py + second_head.py): the SECOND RPN and
    an IoU head over a rotated G x G BEV grid per RoI; at inference the IoU
    prediction recalibrates the proposal score (sqrt(cls * iou))."""

    def __init__(self, cfg: DetectorConfig,
                 roi_cfg: RoIHeadConfig = RoIHeadConfig(
                     use_corner_loss=False), in_channels: int = 4, *,
                 device, generator):
        super().__init__()
        self.cfg, self.roi_cfg = cfg, roi_cfg
        kw = dict(device=device, generator=generator)
        self.trunk = VoxelDenseTrunk(cfg, in_channels, **kw)
        bev_ch = self.trunk.backbone_2d.num_bev_features
        self.dense_head = AnchorHeadSingle(
            bev_ch, cfg.head, anchor_set_for(cfg).num_per_loc,
            _coder(cfg).full_code_size, **kw)
        self.iou_head = RefinementMLP(roi_cfg.bev_grid_size ** 2 * bev_ch,
                                      roi_cfg, iou_head=True, **kw)
        self.sampler_generator = torch.Generator(device=device)

    def _pool(self, bev: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) BEV bilinearly sampled at G x G points of each
        rotated RoI footprint (second_head.roi_grid_pool) -> (B, R,
        G^2 C)."""
        c = self.cfg
        g, ds = self.roi_cfg.bev_grid_size, self.roi_cfg.bev_downsample
        u = (torch.arange(g, device=rois.device) + 0.5) / g - 0.5
        gx, gy = torch.meshgrid(u, u, indexing="ij")
        lx = gx.reshape(-1) * rois[..., None, 3]                 # (B, R, G2)
        ly = gy.reshape(-1) * rois[..., None, 4]
        cosa = torch.cos(rois[..., 6])[..., None]
        sina = torch.sin(rois[..., 6])[..., None]
        wx = lx * cosa - ly * sina + rois[..., None, 0]
        wy = lx * sina + ly * cosa + rois[..., None, 1]
        fx = (wx - c.point_cloud_range[0]) / (c.voxel_size[0] * ds)
        fy = (wy - c.point_cloud_range[1]) / (c.voxel_size[1] * ds)
        b, r = rois.shape[:2]
        f = bilinear_interpolate_bev(bev, fx.reshape(b, -1),
                                     fy.reshape(b, -1))
        return f.reshape(b, r, -1)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        with cudnn_autotuned():
            bev2d, _ = self.trunk(batch)
            rpn = self.dense_head(bev2d)
        stage1 = _stage1_proposals(self.cfg, self.roi_cfg, rpn, batch,
                                   self.training, self.sampler_generator)
        pooled = self._pool(bev_channels_last(bev2d.detach()),
                            stage1["rois"])
        rcnn_iou, _ = self.iou_head(pooled, stage1["roi_valid"])
        return {"rpn": rpn, "rcnn_iou": rcnn_iou, **stage1}

    def loss(self, preds, batch: DetBatch):
        losses = anchor_head_loss(preds["rpn"], anchor_set_for(self.cfg),
                                  _coder(self.cfg), self.cfg.head,
                                  batch.gt_boxes, batch.gt_classes,
                                  batch.gt_valid)
        # the IoU target is the RoI's IoU with its GT, [0, 1] -> [-1, 1]
        iou_t = preds["gt_iou_of_rois"] * 2.0 - 1.0
        valid = preds["roi_valid"].to(torch.float32)
        l1 = (torch.tanh(preds["rcnn_iou"]) - iou_t).abs() * valid
        losses["rcnn_loss_iou"] = l1.sum() / torch.clamp(valid.sum(),
                                                         min=1.0)
        losses["loss"] = losses["rpn_loss"] + losses["rcnn_loss_iou"]
        return losses

    def predict(self, preds):
        """score = sqrt(cls * iou) (second_net_iou.py's score fusion)."""
        iou = (torch.tanh(preds["rcnn_iou"]) + 1.0) / 2.0
        score = torch.sqrt(preds["roi_scores"].clamp(min=1e-6)
                           * iou.clamp(min=1e-6))
        score = score * preds["roi_valid"].to(score.dtype)
        return post_processing(score[..., None], preds["rois"], self.cfg.nms,
                               cls_preds_normalized=True,
                               valid=preds["roi_valid"])


@register_detector("PVRCNN")
@register_detector("PV-RCNN")
def _build_pvrcnn(cfg, **kw):
    return PVRCNNDetector(cfg, **kw)


@register_detector("SECONDNetIoU")
def _build_second_iou(cfg, **kw):
    return SECONDIoUDetector(cfg, **kw)
