"""VoxelNeXt: the fully sparse detector (detection/voxelnext.py; pcdet
spconv_backbone_voxelnext.py and dense_heads/voxelnext_head.py).

A residual sparse encoder to stride 32 (every 3^3 layer on the port's K3 /
K4 over maps built on the device, detection/sparse_backbones.py), the
coords of strides 16 and 32 rescaled into the stride-8 frame and
concatenated along the voxel axis, a BEV collapse that sums features over
each unique (y, x), a stride-1 (1, 3, 3) conv whose output set is the
input set dilated by one BEV cell (SparseConv3dDown: gather + matmul,
capped at ``dilate_factor * max_bev_voxels`` sites, the smallest keys
kept), a 3^3 submanifold conv on the z = 1 plane, and a sparse
CenterPoint-style head with top-K decode and class-agnostic NMS.

The BEV collapse is a fixed-size unique built from a sort
(ops/voxel.py: fixed_size_unique).

At ``DetectorConfig.dtype`` bfloat16 the backbone's sparse convs (the
residual stages, conv_out and shared_conv) compute in bf16 and their
BatchNorms return float32, as the JAX module's (voxelnext.py:151); the
BEV collapse sums float32 features and the heads are float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import linear
from ..models.sparse_backbone import SparseConvBlock, SparseTensor
from ..ops.device_rulebook import neighbor_map
from ..ops.sparse_maps import ConvMaps
from ..ops.voxel import fixed_size_unique
from ..train import loss_lib
from .dense_heads import _gaussian_radius, top_k_stable
from .detectors import (DetBatch, DetectorConfig, SparseOutConv,
                        register_detector, _check_dtype)
from .post import class_agnostic_nms
from .sparse_backbones import add_res_stages, run_res_stages, stage_maps
from .vfe import mean_vfe

@dataclasses.dataclass(frozen=True)
class VoxelNeXtConfig:
    channels: Tuple[int, ...] = (16, 32, 64, 128, 128)
    out_channel: int = 128
    max_bev_voxels: int = 4000
    # conv_out's dilated-set cap as a multiple of max_bev_voxels (a 3x3 BEV
    # dilation of scattered cells can reach 9x; 4x covers clustered scenes)
    dilate_factor: int = 4
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    cls_weight: float = 1.0
    loc_weight: float = 0.25
    max_boxes: int = 500


def bev_collapse(coords: torch.Tensor, valid: torch.Tensor,
                 feats: torch.Tensor, width: int, max_bev: int):
    """Sum (B, M, C) features over each unique (y, x) of (B, M, 3) zyx
    coords (voxelnext bev_out): the ``max_bev`` smallest keys y * width + x
    are kept (``jnp.unique(size=)``), from a sort and a rank. Returns
    (features (B, max_bev, C), coords (B, max_bev, 3) with z = 0, valid)."""
    b = coords.shape[0]
    key = torch.where(valid, coords[..., 1].long() * width
                      + coords[..., 2].long(), -1)
    uniq, uvalid, seg, hit = fixed_size_unique(key, max_bev)
    c = feats.shape[-1]
    summed = feats.new_zeros((b, max_bev + 1, c)).scatter_add(
        1, seg[..., None].expand(-1, -1, c),
        feats * hit[..., None].to(feats.dtype))[:, :max_bev]
    safe = torch.where(uvalid, uniq, 0)
    coords2d = torch.stack([torch.zeros_like(safe), safe // width,
                            safe % width], dim=-1).to(torch.int32)
    return summed, coords2d, uvalid


_PADDINGS = ((1, 1, 1),) * 6


class VoxelNeXtBackbone(nn.Module):
    """The residual encoder to stride 32 + the cross-scale sparse BEV
    collapse, conv_out and shared_conv, the sparse convs at ``dtype``.
    ``dropped_sites`` holds each strided stage's sites cut off by its
    cap."""

    def __init__(self, cfg: VoxelNeXtConfig, in_channels: int = 4,
                 max_voxels_per_stage=(16000, 16000, 8000, 4000), *, device,
                 generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        caps = tuple(max_voxels_per_stage)
        self.caps = caps + (max(caps[3] // 2, 1), max(caps[3] // 4, 1))
        ch = cfg.channels
        kw = dict(device=device, generator=generator, dtype=dtype)
        add_res_stages(self, in_channels, tuple(ch) + (ch[4],), **kw)
        self.conv_out = SparseOutConv(
            ch[4], cfg.out_channel, cfg.dilate_factor * cfg.max_bev_voxels,
            conv=dict(kernel_size=(1, 3, 3), stride=1, padding=(0, 1, 1)),
            **kw)
        self.shared_conv = SparseConvBlock(cfg.out_channel, cfg.out_channel,
                                           **kw)
        self.dropped_sites: Dict[int, torch.Tensor] = {}

    def forward(self, st: SparseTensor) -> SparseTensor:
        rb, maps, self.dropped_sites = stage_maps(st, None, self.caps,
                                                  _PADDINGS)
        outs = run_res_stages(self, st, rb, maps, _PADDINGS, 6)
        x4, x5, x6 = outs[3], outs[4], outs[5]
        f4 = x4.features
        ch4 = self.cfg.channels[4]
        if f4.shape[-1] < ch4:
            f4 = F.pad(f4, (0, ch4 - f4.shape[-1]))
        # strides 16 and 32 into the stride-8 frame (backbone:194-195)
        feats = torch.cat([f4, x5.features, x6.features], dim=1)
        coords = torch.cat([x4.coords, x5.coords * 2, x6.coords * 4], dim=1)
        valid = torch.cat([x4.valid, x5.valid, x6.valid], dim=1)
        _, h, w = x4.spatial_shape
        bev_f, bev_c, bev_v = bev_collapse(coords, valid, feats, w,
                                           self.cfg.max_bev_voxels)
        bev = self.conv_out(SparseTensor(bev_f, bev_c, bev_v, (1, h, w)))
        nbr = neighbor_map(bev.coords, bev.valid, bev.spatial_shape)
        f = self.shared_conv(bev.features, None, ConvMaps(nbr, nbr, True),
                             bev.valid)
        return dataclasses.replace(bev, features=f)


class VoxelNeXtDetector(nn.Module):
    """VoxelNeXt (voxelnext.py + voxelnext_head.py): a sparse heatmap head
    on the collapsed BEV voxel set; top-K decode then class-agnostic NMS
    against duplicates from adjacent cells."""

    def __init__(self, cfg: DetectorConfig,
                 vn_cfg: VoxelNeXtConfig = VoxelNeXtConfig(),
                 in_channels: int = 4, *, device, generator):
        super().__init__()
        self.cfg, self.vn_cfg = cfg, vn_cfg
        kw = dict(device=device, generator=generator)
        self.backbone_3d = VoxelNeXtBackbone(
            vn_cfg, in_channels, cfg.max_voxels_per_stage,
            dtype=_check_dtype(cfg), **kw)
        self.hm_out = linear(vn_cfg.out_channel, len(cfg.class_names), **kw)
        with torch.no_grad():
            self.hm_out.bias.fill_(-2.19)
        self.reg_out = linear(vn_cfg.out_channel, 8, **kw)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        feats = mean_vfe(batch.voxels, batch.voxel_num_points)
        feats = feats * batch.voxel_valid[..., None].to(feats.dtype)
        bev = self.backbone_3d(SparseTensor(
            feats, batch.voxel_coords, batch.voxel_valid,
            self.cfg.sparse_shape))
        # cx, cy, z, log dims, cos, sin per active BEV voxel; padded rows'
        # coords 0, as the JAX package's
        return {"hm": self.hm_out(bev.features),
                "reg": self.reg_out(bev.features),
                "bev_coords": torch.where(bev.valid[..., None], bev.coords, 0),
                "bev_valid": bev.valid}

    def _cells(self) -> Tuple[float, float]:
        c = self.cfg
        return c.voxel_size[0] * 8, c.voxel_size[1] * 8     # stride 8

    def _targets(self, preds, batch: DetBatch):
        """Sparse gaussian heatmap targets on the active set and each GT's
        nearest active voxel (voxelnext_head.assign_target_of_single_head
        on the active set instead of a dense map)."""
        c, vn = self.cfg, self.vn_cfg
        vx, vy = self._cells()
        coords, valid = preds["bev_coords"], preds["bev_valid"]
        gt, gtc, gtv = batch.gt_boxes, batch.gt_classes, batch.gt_valid
        px = coords[..., 2].to(torch.float32)                  # (B, M)
        py = coords[..., 1].to(torch.float32)
        cx = (gt[..., 0] - c.point_cloud_range[0]) / vx         # (B, G)
        cy = (gt[..., 1] - c.point_cloud_range[1]) / vy
        radius = torch.clamp(_gaussian_radius(
            gt[..., 4] / vy, gt[..., 3] / vx, vn.gaussian_overlap).to(
            torch.int32), min=vn.min_radius).to(torch.float32)
        ok = gtv & (gt[..., 3] > 0)
        d2 = (px[:, None, :] - cx[..., None]) ** 2 \
            + (py[:, None, :] - cy[..., None]) ** 2              # (B, G, M)
        sigma = (2 * radius + 1) / 6.0
        g = torch.exp(-d2 / (2 * sigma[..., None] ** 2))
        trunc = d2 <= (radius[..., None] ** 2) * 2.0
        g = torch.where(trunc & ok[..., None] & valid[:, None, :], g, 0.0)
        nc = len(c.class_names)
        onehot = F.one_hot((gtc.long() - 1).clamp(min=0), nc).to(g.dtype) \
            * ((gtc >= 1) & (gtc <= nc))[..., None].to(g.dtype)
        hm_t = torch.amax(g[..., None] * onehot[:, :, None, :], dim=1)
        nearest = torch.argmin(torch.where(valid[:, None, :], d2, torch.inf),
                               dim=-1)                          # (B, G)
        reg_t = torch.cat([
            (cx - torch.gather(px, 1, nearest))[..., None],
            (cy - torch.gather(py, 1, nearest))[..., None],
            gt[..., 2:3], torch.log(gt[..., 3:6].clamp(min=1e-5)),
            torch.cos(gt[..., 6:7]), torch.sin(gt[..., 6:7])], dim=-1)
        return hm_t, reg_t, nearest, ok

    def loss(self, preds, batch: DetBatch, denominator=loss_lib.local_count
             ) -> Dict[str, torch.Tensor]:
        vn = self.vn_cfg
        with torch.no_grad():
            hm_t, reg_t, nearest, ok = self._targets(preds, batch)
        p = torch.sigmoid(preds["hm"]).clamp(1e-4, 1 - 1e-4)
        p = p * preds["bev_valid"][..., None].to(p.dtype)
        hm_loss = loss_lib.gaussian_focal_loss(
            p, hm_t, denominator=denominator) * vn.cls_weight
        gathered = torch.gather(preds["reg"], 1, nearest[..., None].expand(
            -1, -1, preds["reg"].shape[-1]))
        m = ok[..., None].to(gathered.dtype)
        loc = ((gathered - reg_t).abs() * m).sum() \
            / denominator(m.sum()) * vn.loc_weight
        return {"hm_loss": hm_loss, "loc_loss": loc, "loss": hm_loss + loc}

    def predict(self, preds) -> Dict[str, torch.Tensor]:
        c = self.cfg
        vx, vy = self._cells()
        scores_all = torch.sigmoid(preds["hm"]) \
            * preds["bev_valid"][..., None].to(torch.float32)
        b, m, nc = scores_all.shape
        scores, idx = top_k_stable(scores_all.reshape(b, m * nc),
                                   min(self.vn_cfg.max_boxes, m * nc))
        vidx = idx // nc
        cls = (idx % nc + 1).to(torch.int32)
        coords = torch.gather(preds["bev_coords"], 1,
                              vidx[..., None].expand(-1, -1, 3))
        r = torch.gather(preds["reg"], 1, vidx[..., None].expand(-1, -1, 8))
        x = (coords[..., 2].to(torch.float32) + r[..., 0]) * vx \
            + c.point_cloud_range[0]
        y = (coords[..., 1].to(torch.float32) + r[..., 1]) * vy \
            + c.point_cloud_range[1]
        boxes = torch.cat([x[..., None], y[..., None], r[..., 2:3],
                           torch.exp(r[..., 3:6]),
                           torch.atan2(r[..., 7], r[..., 6])[..., None]],
                          dim=-1)
        outs = []
        for sc, bx, lb in zip(scores, boxes, cls):
            i, s, v = class_agnostic_nms(sc, bx, c.nms)
            outs.append((bx[i], s, lb[i], v))
        bx, sc, lb, vd = (torch.stack([o[i] for o in outs]) for i in range(4))
        return {"boxes": bx, "scores": sc,
                "labels": lb * vd.to(torch.int32), "valid": vd}


@register_detector("VoxelNeXt")
def _build_voxelnext(cfg, **kw):
    return VoxelNeXtDetector(cfg, **kw)
