"""The detection batch, DetectorConfig and the voxel trunk (detection/
detectors.py): MeanVFE -> VoxelBackbone8x (the frozen models/
sparse_backbone.py, on the maps it builds on the device) -> conv_out (a
strided sparse conv built on the device, models/sparse_backbone.py:
SparseConv3dDown) -> HeightCompression -> BaseBEVBackbone, at float32."""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import KAIMING, BatchNorm, draw
from ..models.sparse_backbone import SparseTensor, VoxelBackbone8x
from ..ops.device_rulebook import (conv_out_shape, down_map,
                                   downsample_active_set, stage_shape)
from ..ops.sparse_maps import gather_taps
from .anchors import (AnchorClassConfig, KITTI_ANCHORS, KITTI_CLASS_NAMES,
                      KITTI_POINT_CLOUD_RANGE, KITTI_VOXEL_SIZE)
from .bev import BaseBEVBackbone, sparse_to_dense_bev
from .box_coders import ResidualCoder
from .dense_heads import AnchorHeadConfig
from .post import NMSConfig
from .target_assign import AnchorSet, build_anchor_set
from .vfe import mean_vfe


@dataclasses.dataclass(frozen=True)
class CenterHeadConfig:
    """A placeholder for the port's field of the same name: the reference
    builds no CenterPoint head."""


class SparseConv3dDown(nn.Module):
    """A strided sparse conv of any (kz, ky, kx) kernel, per-axis stride and
    padding, without bias (models/sparse_backbone.py: SparseConv3dDown
    without a rulebook): the output active set and the gather map are built
    on the features' device (ops/device_rulebook.py), the smallest
    ``max_out_voxels`` output keys kept; the layer is a row gather and one
    matmul, differentiated by autograd. The detectors' conv_out, a (3, 1, 1)
    kernel at stride (2, 1, 1), is one; ``dropped_sites`` holds the (B,)
    output sites its cap cut off in the last forward. Weight layout:
    (kz * ky * kx, Cin, Cout) in (dz, dy, dx) scan order. At ``dtype``
    bfloat16 the gathered taps and the weights are rounded to bf16 and the
    product is one bf16 matmul (a float32 sum rounded once, as the JAX
    package's einsum outside any kernel, sparse_backbone.py:298-299)."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=2,
                 padding=1, max_out_voxels: int = 16000, *, device,
                 generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kz, ky, kx = ((kernel_size,) * 3 if isinstance(kernel_size, int)
                      else tuple(kernel_size))
        self.kernel_size = (kz, ky, kx)
        self.stride, self.padding = stride, padding
        self.max_out_voxels = max_out_voxels
        k3 = kz * ky * kx
        self.weight = nn.Parameter(draw((k3, cin, cout),
                                        (KAIMING / (k3 * cin)) ** 0.5,
                                        device=device, generator=generator))
        self.dropped_sites: Optional[torch.Tensor] = None

    def forward(self, st: SparseTensor) -> SparseTensor:
        args = (self.kernel_size, self.stride, self.padding)
        out_shape = conv_out_shape(st.spatial_shape, *args)
        with torch.no_grad():
            coords, valid, _, self.dropped_sites = downsample_active_set(
                st.coords, st.valid, out_shape, self.stride, self.padding,
                self.max_out_voxels, self.kernel_size)
            idx = down_map(st.coords, st.valid, st.spatial_shape, coords,
                           valid, self.stride, self.padding,
                           self.kernel_size)
        gathered = gather_taps(st.features, idx)             # (B, Mo, K, C)
        b, mo = idx.shape[:2]
        w = self.weight.reshape(-1, self.weight.shape[-1])
        out = gathered.reshape(b, mo, -1) @ w
        out = out * valid[..., None].to(out.dtype)
        return SparseTensor(out, coords, valid, out_shape)



class SparseOutConv(nn.Module):
    """A sparse conv that builds its output set (SparseConv3dDown) + BN
    (eps 1e-3, momentum 0.99, masked in training) + ReLU: conv_out, a
    (3, 1, 1) stride-(2, 1, 1) conv by default (spconv_backbone.py:109-117);
    ``conv`` gives another kernel, stride and padding."""

    def __init__(self, cin: int = 64, out_channels: int = 128,
                 max_out_voxels: int = 4000, conv: Optional[dict] = None, *,
                 device, generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SparseConv3dDown(cin, out_channels,
                                     max_out_voxels=max_out_voxels,
                                     device=device, generator=generator,
                                     dtype=dtype, **(conv or CONV_OUT))
        self.bn = BatchNorm(out_channels, 1e-3, device=device, momentum=0.99)

    def forward(self, st: SparseTensor) -> SparseTensor:
        st = self.conv(st)
        f = F.relu(self.bn(st.features, st.valid)) \
            * st.valid[..., None].to(st.features.dtype)
        return dataclasses.replace(st, features=f)



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


CONV_OUT = dict(kernel_size=(3, 1, 1), stride=(2, 1, 1), padding=0)


class VoxelDenseTrunk(nn.Module):
    """MeanVFE -> VoxelBackbone8x -> conv_out -> BEV -> BaseBEVBackbone
    (SECOND, CenterPoint, VoxelRCNN-Det). Returns the NCHW BEV map and the
    backbone's multi-scale sparse features (float32 at either dtype)."""

    def __init__(self, cfg: DetectorConfig, in_channels: int = 4, *, device,
                 generator):
        super().__init__()
        if cfg.dtype != "float32":
            raise ValueError("the reference runs at float32")
        self.dtype = torch.float32
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.backbone_3d = VoxelBackbone8x(
            in_channels, x_window=cfg.x_window,
            max_voxels_per_stage=cfg.max_voxels_per_stage, dtype=self.dtype,
            **kw)
        self.conv_out = SparseOutConv(
            64, 128, max_out_voxels=cfg.max_voxels_per_stage[3],
            dtype=self.dtype, **kw)
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



def _bev_backbone(cfg: DetectorConfig, cin: int, **kw) -> BaseBEVBackbone:
    return BaseBEVBackbone(cin, cfg.bev_layer_nums, cfg.bev_layer_strides,
                           cfg.bev_num_filters, cfg.bev_upsample_strides,
                           cfg.bev_num_upsample_filters, **kw)
