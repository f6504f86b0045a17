"""The dense single-stage detectors (detection/detectors.py; pcdet
detectors/): SECOND, PointPillar, PillarNet and CenterPoint, each a
composition of VFE -> 3D backbone -> map-to-BEV -> 2D backbone -> dense
head, with its loss and fixed-shape post-processing; and the zoo's
registry and default configs.

The voxel trunk runs the port's VoxelBackbone8x (models/sparse_backbone.py)
and so its sparse conv kernels: K3 over the host rulebook's nbr / down maps
or over maps built on the device, or the x-window kernel where
``DetectorConfig.x_window`` is set and the rulebook carries its maps. The
other families: roi_detectors.py (VoxelRCNN-Det, PV-RCNN, SECOND-IoU),
parta2.py, point_rcnn.py, voxelnext.py, pv_rcnn_pp.py, caddn.py and
mppnet.py.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm
from ..models.sparse_backbone import (SparseConv3dDown, SparseTensor,
                                      VoxelBackbone8x)
from ..ops.device_rulebook import conv_out_shape, stage_shape
from .anchors import (AnchorClassConfig, KITTI_ANCHORS, KITTI_CLASS_NAMES,
                      KITTI_PILLAR_RANGE, KITTI_PILLAR_SIZE,
                      KITTI_POINT_CLOUD_RANGE, KITTI_VOXEL_SIZE)
from .bev import (BaseBEVBackbone, cudnn_autotuned, pillar_scatter,
                  sparse_to_dense_bev)
from .box_coders import ResidualCoder
from .dense_heads import (AnchorHeadConfig, AnchorHeadSingle, CenterHead,
                          CenterHeadConfig, anchor_head_loss,
                          center_head_loss, decode_anchor_preds,
                          decode_center_preds)
from .post import NMSConfig, class_agnostic_nms, post_processing
from .target_assign import AnchorSet, build_anchor_set
from .vfe import PillarVFE, mean_vfe


@dataclasses.dataclass
class DetBatch:
    """Padded detection batch (collate_batch's analogue for the zoo), its
    tensors on one device."""
    voxels: torch.Tensor            # (B, M, P, C)
    voxel_coords: torch.Tensor      # (B, M, 3) int32 zyx
    voxel_num_points: torch.Tensor  # (B, M)
    voxel_valid: torch.Tensor       # (B, M) bool
    gt_boxes: torch.Tensor          # (B, G, 7)
    gt_classes: torch.Tensor        # (B, G) int32 1-based
    gt_valid: torch.Tensor          # (B, G) bool
    rulebook: Optional[Dict[str, torch.Tensor]] = None
    points: Optional[torch.Tensor] = None        # (B, N, 4+) raw points
    point_valid: Optional[torch.Tensor] = None   # (B, N) bool
    # camera detectors (CaDDN), NHWC as in the JAX package
    images: Optional[torch.Tensor] = None        # (B, H, W, 3)
    lidar_to_cam: Optional[torch.Tensor] = None  # (B, 4, 4)
    cam_to_img: Optional[torch.Tensor] = None    # (B, 3, 4)
    depth_maps: Optional[torch.Tensor] = None    # (B, H, W) GT depth

    def to(self, device) -> "DetBatch":
        def conv(v):
            if v is None:
                return None
            if isinstance(v, dict):
                return {k: t.to(device) for k, t in v.items()}
            return v.to(device)
        return DetBatch(**{f.name: conv(getattr(self, f.name))
                           for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    name: str = "SECOND"
    class_names: Tuple[str, ...] = KITTI_CLASS_NAMES
    point_cloud_range: Tuple[float, ...] = KITTI_POINT_CLOUD_RANGE
    voxel_size: Tuple[float, float, float] = KITTI_VOXEL_SIZE
    max_voxels_per_stage: Tuple[int, int, int, int] = (16000, 16000, 8000, 4000)
    anchors: Tuple[AnchorClassConfig, ...] = KITTI_ANCHORS
    head: AnchorHeadConfig = AnchorHeadConfig()
    center_head: CenterHeadConfig = CenterHeadConfig()
    nms: NMSConfig = NMSConfig()
    # 2D BEV trunk
    bev_layer_nums: Tuple[int, ...] = (5, 5)
    bev_layer_strides: Tuple[int, ...] = (1, 2)
    bev_num_filters: Tuple[int, ...] = (128, 256)
    bev_upsample_strides: Tuple[int, ...] = (1, 2)
    bev_num_upsample_filters: Tuple[int, ...] = (256, 256)
    # pillar families
    pillar_filters: Tuple[int, ...] = (64,)
    # the x-window kernel for VoxelBackbone8x where the rulebook carries its
    # maps (the BEV scatter does not depend on the voxel order)
    x_window: bool = False
    dtype: str = "float32"

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        pr, vs = self.point_cloud_range, self.voxel_size
        return (int(round((pr[3] - pr[0]) / vs[0])),
                int(round((pr[4] - pr[1]) / vs[1])),
                int(round((pr[5] - pr[2]) / vs[2])))

    @property
    def sparse_shape(self) -> Tuple[int, int, int]:
        nx, ny, nz = self.grid_size
        return (nz + 1, ny, nx)          # z padded by 1, reference convention


@functools.lru_cache(maxsize=32)
def anchor_set_for(cfg: DetectorConfig) -> AnchorSet:
    return build_anchor_set(cfg.anchors, cfg.grid_size[:2],
                            cfg.point_cloud_range)


def _coder(cfg: DetectorConfig) -> ResidualCoder:
    return ResidualCoder(
        encode_angle_by_sincos=cfg.head.encode_angle_by_sincos)


def _check_dtype(cfg: DetectorConfig) -> None:
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"DetectorConfig.dtype {cfg.dtype!r}: the port runs float32 "
            "(ROADMAP Queue 1, model.dtype)")


CONV_OUT = dict(kernel_size=(3, 1, 1), stride=(2, 1, 1), padding=0)


class SparseOutConv(nn.Module):
    """A sparse conv that builds its output set (SparseConv3dDown) + BN
    (eps 1e-3, momentum 0.99, masked in training) + ReLU: conv_out, a
    (3, 1, 1) stride-(2, 1, 1) conv by default (spconv_backbone.py:109-117);
    ``conv`` gives another kernel, stride and padding."""

    def __init__(self, cin: int = 64, out_channels: int = 128,
                 max_out_voxels: int = 4000, conv: Optional[dict] = None, *,
                 device, generator):
        super().__init__()
        self.conv = SparseConv3dDown(cin, out_channels,
                                     max_out_voxels=max_out_voxels,
                                     device=device, generator=generator,
                                     **(conv or CONV_OUT))
        self.bn = BatchNorm(out_channels, 1e-3, device=device, momentum=0.99)

    def forward(self, st: SparseTensor) -> SparseTensor:
        st = self.conv(st)
        f = F.relu(self.bn(st.features, st.valid)) \
            * st.valid[..., None].to(st.features.dtype)
        return dataclasses.replace(st, features=f)


def _bev_backbone(cfg: DetectorConfig, cin: int, **kw) -> BaseBEVBackbone:
    return BaseBEVBackbone(cin, cfg.bev_layer_nums, cfg.bev_layer_strides,
                           cfg.bev_num_filters, cfg.bev_upsample_strides,
                           cfg.bev_num_upsample_filters, **kw)


class VoxelDenseTrunk(nn.Module):
    """MeanVFE -> VoxelBackbone8x -> conv_out -> BEV -> BaseBEVBackbone
    (SECOND, CenterPoint, VoxelRCNN-Det). Returns the NCHW BEV map and the
    backbone's multi-scale sparse features."""

    def __init__(self, cfg: DetectorConfig, in_channels: int = 4, *, device,
                 generator):
        super().__init__()
        _check_dtype(cfg)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.backbone_3d = VoxelBackbone8x(
            in_channels, x_window=cfg.x_window,
            max_voxels_per_stage=cfg.max_voxels_per_stage, **kw)
        self.conv_out = SparseOutConv(
            64, 128, max_out_voxels=cfg.max_voxels_per_stage[3], **kw)
        shape = cfg.sparse_shape
        for k in (1, 2, 3):
            shape = stage_shape(shape, k)
        depth = conv_out_shape(shape, **CONV_OUT)[0]
        self.backbone_2d = _bev_backbone(cfg, depth * 128, **kw)

    def forward(self, batch: DetBatch):
        feats = mean_vfe(batch.voxels, batch.voxel_num_points)
        feats = feats * batch.voxel_valid[..., None].to(feats.dtype)
        st = SparseTensor(feats, batch.voxel_coords, batch.voxel_valid,
                          self.cfg.sparse_shape)
        ms = self.backbone_3d(st, batch.rulebook)
        bev = sparse_to_dense_bev(self.conv_out(ms["x_conv4"]))
        return self.backbone_2d(bev), ms


class PillarTrunk(nn.Module):
    """PillarVFE -> scatter -> BaseBEVBackbone (PointPillar, PillarNet)."""

    def __init__(self, cfg: DetectorConfig, in_channels: int = 4, *, device,
                 generator):
        super().__init__()
        _check_dtype(cfg)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.vfe = PillarVFE(cfg.pillar_filters, cfg.voxel_size,
                             cfg.point_cloud_range,
                             num_point_features=in_channels, **kw)
        self.backbone_2d = _bev_backbone(cfg, cfg.pillar_filters[-1], **kw)

    def forward(self, batch: DetBatch):
        pf = self.vfe(batch.voxels, batch.voxel_coords,
                      batch.voxel_num_points, batch.voxel_valid)
        canvas = pillar_scatter(pf, batch.voxel_coords, batch.voxel_valid,
                                self.cfg.grid_size[:2])
        return self.backbone_2d(canvas), None


class AnchorDetector(nn.Module):
    """Single-stage anchor detector = trunk + AnchorHeadSingle: SECOND
    (trunk "voxel"), PointPillar / PillarNet (trunk "pillar")."""

    def __init__(self, cfg: DetectorConfig, trunk: str = "voxel",
                 in_channels: int = 4, *, device, generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.trunk = (VoxelDenseTrunk if trunk == "voxel" else PillarTrunk)(
            cfg, in_channels, **kw)
        self.dense_head = AnchorHeadSingle(
            self.trunk.backbone_2d.num_bev_features, cfg.head,
            anchor_set_for(cfg).num_per_loc, _coder(cfg).full_code_size,
            **kw)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        with cudnn_autotuned():
            bev2d, _ = self.trunk(batch)
            return self.dense_head(bev2d)

    def loss(self, preds, batch: DetBatch) -> Dict[str, torch.Tensor]:
        losses = anchor_head_loss(preds, anchor_set_for(self.cfg),
                                  _coder(self.cfg), self.cfg.head,
                                  batch.gt_boxes, batch.gt_classes,
                                  batch.gt_valid)
        losses["loss"] = losses["rpn_loss"]
        return losses

    def predict(self, preds) -> Dict[str, torch.Tensor]:
        cls, boxes = decode_anchor_preds(preds, anchor_set_for(self.cfg),
                                         _coder(self.cfg), self.cfg.head)
        return post_processing(cls, boxes, self.cfg.nms)


class CenterPointDetector(nn.Module):
    """CenterPoint (centerpoint.py): voxel trunk + CenterHead."""

    def __init__(self, cfg: DetectorConfig, in_channels: int = 4, *, device,
                 generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.trunk = VoxelDenseTrunk(cfg, in_channels, **kw)
        self.dense_head = CenterHead(self.trunk.backbone_2d.num_bev_features,
                                     cfg.center_head, **kw)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        with cudnn_autotuned():
            bev2d, _ = self.trunk(batch)
            return self.dense_head(bev2d)

    def loss(self, preds, batch: DetBatch) -> Dict[str, torch.Tensor]:
        c = self.cfg
        losses = center_head_loss(preds, c.center_head, c.grid_size,
                                  c.voxel_size, c.point_cloud_range,
                                  batch.gt_boxes, batch.gt_classes,
                                  batch.gt_valid)
        losses["loss"] = losses["center_loss"]
        return losses

    def predict(self, preds) -> Dict[str, torch.Tensor]:
        c = self.cfg
        scores, labels, boxes = decode_center_preds(
            preds, c.center_head, c.grid_size, c.voxel_size,
            c.point_cloud_range, max_boxes=min(c.nms.nms_pre_maxsize, 500))
        # center_head.py:285 runs class-agnostic NMS on the decoded boxes
        outs = []
        for sc, bx, lb in zip(scores, boxes, labels):
            idx, s, v = class_agnostic_nms(sc, bx, c.nms)
            outs.append((bx[idx], s, lb[idx], v))
        bx, sc, lb, vd = (torch.stack([o[i] for o in outs]) for i in range(4))
        return {"boxes": bx, "scores": sc,
                "labels": lb * vd.to(torch.int32), "valid": vd}


# ---------------------------------------------------------------------------
# Registry (pcdet build_detector)
# ---------------------------------------------------------------------------

def _pillar_cfg(name: str, **kw) -> DetectorConfig:
    pillar_anchors = tuple(
        dataclasses.replace(a, feature_map_stride=2) for a in KITTI_ANCHORS)
    return DetectorConfig(
        name=name, point_cloud_range=KITTI_PILLAR_RANGE,
        voxel_size=KITTI_PILLAR_SIZE, anchors=pillar_anchors,
        bev_layer_nums=(3, 5, 5), bev_layer_strides=(2, 2, 2),
        bev_num_filters=(64, 128, 256), bev_upsample_strides=(1, 2, 4),
        bev_num_upsample_filters=(128, 128, 128), **kw)


TWO_STAGE_NAMES = ("VoxelRCNN-Det", "PVRCNN", "PV-RCNN", "SECONDNetIoU",
                   "PartA2", "PartA2Net", "PointRCNN", "PVRCNNPlusPlus",
                   "PV-RCNN++")


# CaDDN's geometry (pcdet tools/cfgs/kitti_models/CaDDN.yaml): the camera
# frustum's range at 0.16 m voxels, a 280 x 376 x 25 grid
CADDN_POINT_CLOUD_RANGE = (2.0, -30.08, -3.0, 46.8, 30.08, 1.0)
CADDN_VOXEL_SIZE = (0.16, 0.16, 0.16)


def default_config(name: str) -> DetectorConfig:
    """The KITTI config of detector ``name`` (the JAX package knows only
    SECOND / SECONDNet, CenterPoint, PointPillar and PillarNet: ROADMAP
    Queue 3). CaDDN takes CaDDN.yaml's geometry and BEV trunk (LAYER_NUMS
    [10, 10, 10], strides 2, filters 64 / 128 / 256, upsampled by 1 / 2 / 4
    to 128 each) with KITTI's anchors at feature-map stride 2; MPPNet and
    MPPNetE2E refine given trajectories and read only its NMS settings."""
    if name in ("SECOND", "SECONDNet"):
        return DetectorConfig(name="SECOND")
    if name == "CaDDN":
        return DetectorConfig(
            name="CaDDN", point_cloud_range=CADDN_POINT_CLOUD_RANGE,
            voxel_size=CADDN_VOXEL_SIZE,
            anchors=tuple(dataclasses.replace(a, feature_map_stride=2)
                          for a in KITTI_ANCHORS),
            bev_layer_nums=(10, 10, 10), bev_layer_strides=(2, 2, 2),
            bev_num_filters=(64, 128, 256), bev_upsample_strides=(1, 2, 4),
            bev_num_upsample_filters=(128, 128, 128))
    if name in TWO_STAGE_NAMES or name in ("CenterPoint", "VoxelNeXt",
                                           "MPPNet", "MPPNetE2E"):
        # SECOND's KITTI trunk; each family's own defaults (VSAConfig,
        # PartA2Config, PointNet2Config, VoxelNeXtConfig, PVPPConfig) are
        # its constructor's
        return DetectorConfig(name=name)
    if name == "PointPillar":
        return _pillar_cfg("PointPillar")
    if name == "PillarNet":
        # pillarnet.py: a deeper pillar trunk, the same head family
        return dataclasses.replace(_pillar_cfg("PillarNet"),
                                   pillar_filters=(64, 128))
    raise KeyError(name)


_DETECTORS = {}


def register_detector(name: str):
    def deco(fn):
        _DETECTORS[name] = fn
        return fn
    return deco


def available_detectors():
    return sorted(_DETECTORS)


def build_detector(name: str, cfg: Optional[DetectorConfig] = None, *,
                   in_channels: int = 4, device="cuda",
                   generator: Optional[torch.Generator] = None):
    """Name -> the port's detector for ``cfg`` (its default config if
    None) on ``device``, weights drawn from ``generator`` (a CPU
    generator, seed 0 by default), for points of ``in_channels`` features
    (flax infers this width from the first batch; nuScenes and Lyft carry
    5, Waymo 5 or more)."""
    from ..utils.device import resolve_device
    if name not in _DETECTORS:
        raise KeyError(f"unknown detector {name!r}; have "
                       f"{available_detectors()}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return _DETECTORS[name](cfg or default_config(name),
                            in_channels=in_channels,
                            device=resolve_device(device),
                            generator=generator)


@register_detector("SECONDNet")
@register_detector("SECOND")
def _build_second(cfg, **kw):
    return AnchorDetector(cfg, trunk="voxel", **kw)


@register_detector("PointPillar")
@register_detector("PillarNet")
def _build_pillar(cfg, **kw):
    return AnchorDetector(cfg, trunk="pillar", **kw)


@register_detector("CenterPoint")
def _build_centerpoint(cfg, **kw):
    return CenterPointDetector(cfg, **kw)
