"""The zoo's remaining modules (detection/extras.py): the multi-head RPN,
the dynamic pillar VFE, the FPN-input BEV trunk, the 2D sparse pillar
backbone and the focal sparse conv.

- AnchorHeadMulti (anchor_head_multi.py): per-class-group anchor heads on
  a shared conv, each scoring only its classes; losses per head, decoded
  predictions concatenated over the anchor axis with -1e4 in the class
  slots a head does not own.
- DynamicPillarVFE (dynamic_pillar_vfe.py): the PFN on raw points with a
  per-pillar segment max; the pillars are the ``max_pillars`` smallest
  keys y * nx + x (ops/voxel.py: fixed_size_unique).
- BaseBEVBackboneV1 (base_bev_backbone.py): two multi-scale NCHW maps,
  each refined, upsampled and concatenated.
- PillarRes18Backbone (spconv_backbone_2d.py PillarRes18BackBone8x): the
  residual sparse backbone on z = 1 SparseTensors; its submanifold layers
  run on K3 (K4 for the weight gradient) over maps built on the device,
  its strided (1, 3, 3) downs through SparseConv3dDown.
- FocalSparseConv (focal_sparse_conv.py): a submanifold conv gated by the
  sigmoid of a learned per-voxel importance, the active set re-selected to
  the top-k most important voxels. The importance conv has one output
  column, which the kernel's tiles cannot hold: it runs as K3 at D = 16
  with the weight padded by zero columns, and column 0 is taken (the same
  function).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, cast, conv2d, linear
from ..models.sparse_backbone import SparseConv, SparseConvBlock, SparseTensor
from ..ops.device_rulebook import neighbor_map
from ..ops.kernels.subm_conv import subm_conv
from ..ops.sparse_maps import ConvMaps
from ..ops.voxel import fixed_size_unique
from .anchors import AnchorClassConfig
from .box_coders import ResidualCoder
from .dense_heads import (AnchorHeadConfig, AnchorHeadSingle,
                          anchor_head_loss, decode_anchor_preds, top_k_stable)
from .detectors import SparseOutConv
from .sparse_backbones import SparseBasicBlock
from .target_assign import build_anchor_set


class AnchorHeadMulti(nn.Module):
    """Grouped multi-head RPN over an NCHW BEV map: a shared 3 x 3 conv
    (no bias) + ReLU, then one AnchorHeadSingle per class group with its
    own anchor set."""

    def __init__(self, cin: int, head_cfg: AnchorHeadConfig,
                 class_groups: Tuple[Tuple[str, ...], ...],
                 anchors: Tuple[AnchorClassConfig, ...],
                 grid_size: Tuple[int, int],
                 point_cloud_range: Tuple[float, ...],
                 shared_channels: int = 64, code_size: int = 7, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.head_cfg = head_cfg
        self.class_groups = tuple(tuple(g) for g in class_groups)
        by_name = {a.class_name: a for a in anchors}
        self.anchor_sets = [build_anchor_set(tuple(by_name[n] for n in grp),
                                             tuple(grid_size),
                                             point_cloud_range)
                            for grp in self.class_groups]
        self.shared_conv = conv2d(cin, shared_channels, 3, 1, 1, **kw)
        for i, (grp, aset) in enumerate(zip(self.class_groups,
                                            self.anchor_sets)):
            self.add_module(f"head_{i}", AnchorHeadSingle(
                shared_channels, self._cfg(grp), aset.num_per_loc,
                code_size, **kw))

    def _cfg(self, grp) -> AnchorHeadConfig:
        return dataclasses.replace(self.head_cfg, num_class=len(grp))

    def _coder(self) -> ResidualCoder:
        return ResidualCoder(
            encode_angle_by_sincos=self.head_cfg.encode_angle_by_sincos)

    def forward(self, bev: torch.Tensor) -> Dict[str, list]:
        x = F.relu(self.shared_conv(bev))
        return {"heads": [getattr(self, f"head_{i}")(x)
                          for i in range(len(self.class_groups))]}

    def loss(self, preds, gt_boxes, gt_classes, gt_valid,
             class_names: Sequence[str]) -> Dict[str, torch.Tensor]:
        out, total = {}, None
        for i, (grp, aset, hp) in enumerate(zip(
                self.class_groups, self.anchor_sets, preds["heads"])):
            # global class ids -> this head's local 1..len(grp)
            gid = torch.zeros_like(gt_classes)
            for local, name in enumerate(grp):
                gid = torch.where(gt_classes == class_names.index(name) + 1,
                                  local + 1, gid)
            li = anchor_head_loss(hp, aset, self._coder(), self._cfg(grp),
                                  gt_boxes, gid, gt_valid & (gid > 0))
            out[f"head{i}_rpn_loss"] = li["rpn_loss"]
            total = li["rpn_loss"] if total is None \
                else total + li["rpn_loss"]
        out["rpn_loss"] = total
        return out

    def decode(self, preds, class_names: Sequence[str]):
        """(cls (B, N, len(class_names)) in global class slots, boxes
        (B, N, 7)), concatenated over the heads."""
        cls_all, box_all = [], []
        for grp, aset, hp in zip(self.class_groups, self.anchor_sets,
                                 preds["heads"]):
            cls, boxes = decode_anchor_preds(hp, aset, self._coder(),
                                             self._cfg(grp))
            full = cls.new_full(cls.shape[:2] + (len(class_names),), -1e4)
            for local, name in enumerate(grp):
                full[..., class_names.index(name)] = cls[..., local]
            cls_all.append(full)
            box_all.append(boxes)
        return torch.cat(cls_all, 1), torch.cat(box_all, 1)


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N, C) rows -> (B, n, C) per-segment max over the rows of
    ``seg`` (B, N) in [0, n); -inf where a segment has no row
    (``jax.ops.segment_max``)."""
    out = x.new_full((x.shape[0], n, x.shape[-1]), float("-inf"))
    return out.scatter_reduce(1, seg[..., None].expand_as(x), x, "amax",
                              include_self=False)


class DynamicPillarVFE(nn.Module):
    """PFN over raw points with a per-pillar segment max. points (B, N, C)
    and point_valid (B, N) -> (pillar features (B, max_pillars, F), zyx
    coords (B, max_pillars, 3) int32 with z = 0, valid (B, max_pillars)),
    ready for pillar_scatter. The pillars are the ``max_pillars`` smallest
    keys y * nx + x of the points in range."""

    def __init__(self, num_filters: Tuple[int, ...] = (64,),
                 voxel_size=(0.16, 0.16, 4.0),
                 point_cloud_range=(0., -39.68, -3., 69.12, 39.68, 1.),
                 max_pillars: int = 4096, num_point_features: int = 4, *,
                 device, generator):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_pillars = max_pillars
        cin = num_point_features + 5
        for i, ch in enumerate(self.num_filters):
            self.add_module(f"pfn{i}", linear(cin, ch, bias=False,
                                              device=device,
                                              generator=generator))
            self.add_module(f"pfn{i}_bn", BatchNorm(ch, 1e-3, device=device,
                                                    momentum=0.99))
            cin = 2 * ch

    def forward(self, points: torch.Tensor, point_valid: torch.Tensor):
        pr = self.point_cloud_range
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        nx = int(round((pr[3] - pr[0]) / vx))
        ny = int(round((pr[4] - pr[1]) / vy))
        mp = self.max_pillars
        b = points.shape[0]
        ix = torch.floor((points[..., 0] - pr[0]) / vx).to(torch.int32)
        iy = torch.floor((points[..., 1] - pr[1]) / vy).to(torch.int32)
        inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & point_valid
        uniq, uvalid, seg, hit = fixed_size_unique(
            torch.where(inb, iy * nx + ix, -1), mp)
        hitf = hit[..., None].to(points.dtype)

        # decorate: [p, p - pillar mean, p_xy - pillar centre]
        sums = points.new_zeros((b, mp + 1, 3)).scatter_add(
            1, seg[..., None].expand(-1, -1, 3), points[..., :3] * hitf)
        cnt = points.new_zeros((b, mp + 1)).scatter_add(1, seg, hitf[..., 0])
        mean = sums / cnt.clamp(min=1.0)[..., None]
        means = torch.gather(mean, 1, seg[..., None].expand(-1, -1, 3))
        safe = torch.where(uvalid, uniq, 0)
        ctr = torch.stack([(safe % nx).to(points.dtype) * vx + vx / 2 + pr[0],
                           (safe // nx).to(points.dtype) * vy + vy / 2
                           + pr[1]], dim=-1)                 # (B, mp, 2)
        ctr_of_pt = torch.gather(ctr, 1, seg.clamp(max=mp - 1)[..., None]
                                 .expand(-1, -1, 2))
        feats = torch.cat([points, points[..., :3] - means,
                           points[..., :2] - ctr_of_pt], dim=-1) * hitf
        for i in range(len(self.num_filters)):
            feats = getattr(self, f"pfn{i}_bn")(getattr(self, f"pfn{i}")(
                feats))
            feats = F.relu(feats) * hitf
            if i < len(self.num_filters) - 1:
                mx = _segment_max(feats, seg, mp + 1)
                feats = torch.cat([feats, torch.gather(
                    mx, 1, seg[..., None].expand_as(feats))], dim=-1)
        pooled = _segment_max(feats, seg, mp + 1)[:, :mp]
        pillar = torch.where(torch.isfinite(pooled), pooled, 0.0)
        coords = torch.stack([torch.zeros_like(safe), safe // nx, safe % nx],
                             dim=-1).to(torch.int32)
        return pillar * uvalid[..., None].to(pillar.dtype), coords, uvalid


class BaseBEVBackboneV1(nn.Module):
    """FPN-input BEV trunk: each of the NCHW ``maps`` through
    ``layer_nums[i]`` 3 x 3 convs (no bias) + BN + ReLU, a transposed conv
    of kernel = stride ``upsample_strides[i]`` + BN + ReLU, concatenated.
    BatchNorm eps 1e-3, momentum 0.99."""

    def __init__(self, in_channels: Tuple[int, ...] = (128, 256),
                 layer_nums: Tuple[int, ...] = (5, 5),
                 num_filters: Tuple[int, ...] = (128, 256),
                 upsample_strides: Tuple[int, ...] = (1, 2),
                 num_upsample_filters: Tuple[int, ...] = (256, 256), *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.layer_nums = tuple(layer_nums)

        def bn(ch):
            return BatchNorm(ch, 1e-3, device=device, momentum=0.99,
                             channel_axis=1)
        for i, (cin, n, ch, us, cu) in enumerate(zip(
                in_channels, layer_nums, num_filters, upsample_strides,
                num_upsample_filters)):
            for k in range(n):
                self.add_module(f"block{i}_l{k}", conv2d(cin, ch, 3, 1, 1,
                                                         **kw))
                self.add_module(f"block{i}_l{k}_bn", bn(ch))
                cin = ch
            self.add_module(f"deblock{i}", conv2d(cin, cu, us, us,
                                                  transposed=True, **kw))
            self.add_module(f"deblock{i}_bn", bn(cu))
        self.num_bev_features = sum(num_upsample_filters)

    def forward(self, maps: Sequence[torch.Tensor]) -> torch.Tensor:
        ups = []
        for i, x in enumerate(maps):
            for k in range(self.layer_nums[i]):
                x = F.relu(getattr(self, f"block{i}_l{k}_bn")(
                    getattr(self, f"block{i}_l{k}")(x)))
            ups.append(F.relu(getattr(self, f"deblock{i}_bn")(
                getattr(self, f"deblock{i}")(x))))
        return torch.cat(ups, dim=1)


def _subm_maps(st: SparseTensor) -> ConvMaps:
    """The submanifold maps of ``st``'s active set, built on its device."""
    nbr = neighbor_map(st.coords, st.valid, st.spatial_shape)
    return ConvMaps(nbr, nbr, True)


class PillarRes18Backbone(nn.Module):
    """Residual sparse pillar backbone on z = 1 SparseTensors: conv_input
    + two SparseBasicBlocks at stride 1, then per stage a strided (1, 3, 3)
    conv at stride (1, 2, 2) (BN + ReLU, capped at
    ``max_voxels_per_stage[i]`` sites) and two SparseBasicBlocks. Returns
    {x_conv1..x_conv4} at strides 1 / 2 / 4 / 8. ``dtype`` is every sparse
    conv's compute dtype, the strided ones' included (bf16 out, float32
    after each BatchNorm, as the JAX module's)."""

    def __init__(self, in_channels: int,
                 channels: Tuple[int, ...] = (32, 64, 128, 256),
                 max_voxels_per_stage: Tuple[int, ...] = (4096, 4096, 2048,
                                                          1024), *,
                 device, generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        ch = tuple(channels)
        self.conv_input = SparseConvBlock(in_channels, ch[0], **kw)
        for j in (0, 1):
            self.add_module(f"res1_{j}", SparseBasicBlock(ch[0], **kw))
        down = dict(kernel_size=(1, 3, 3), stride=(1, 2, 2),
                    padding=(0, 1, 1))
        for i in range(1, 4):
            self.add_module(f"conv{i + 1}_down", SparseOutConv(
                ch[i - 1], ch[i], max_voxels_per_stage[i], conv=down, **kw))
            for j in (0, 1):
                self.add_module(f"res{i + 1}_{j}",
                                SparseBasicBlock(ch[i], **kw))

    def forward(self, st: SparseTensor) -> Dict[str, SparseTensor]:
        maps = _subm_maps(st)
        x = dataclasses.replace(st, features=self.conv_input(
            st.features, None, maps, st.valid))
        for j in (0, 1):
            x = getattr(self, f"res1_{j}")(x, maps)
        out = {"x_conv1": x}
        for i in range(1, 4):
            x = getattr(self, f"conv{i + 1}_down")(x)
            maps = _subm_maps(x)
            for j in (0, 1):
                x = getattr(self, f"res{i + 1}_{j}")(x, maps)
            out[f"x_conv{i + 1}"] = x
        return out


class FocalSparseConv(nn.Module):
    """Learned voxel-importance gating: a submanifold conv (``conv``) and a
    one-column importance conv (``importance``) over the same maps; the
    features are gated by sigmoid(importance) and the active set cut to the
    ``top_k`` most important voxels (lower row first among equals, padded
    rows last). Returns (the new SparseTensor, importance logits (B, M)).
    At ``dtype`` bfloat16 both convs compute in bf16 and the logits, the
    gate and the gated features are bf16, as the JAX module's."""

    def __init__(self, cin: int, out_channels: int, top_k: int, *, device,
                 generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.top_k = top_k
        self.conv = SparseConv(cin, out_channels, **kw)
        self.importance = SparseConv(cin, 1, **kw)

    def forward(self, st: SparseTensor):
        maps = _subm_maps(st)
        feat = self.conv(st.features, None, maps, st.valid)
        # K3's tiles take D >= 16: the weight padded by zero columns
        w16 = F.pad(cast(self.importance.weight, self.importance.dtype),
                    (0, 15))
        imp = subm_conv(st.features, maps.fwd, w16, maps)[..., 0]
        imp = imp * st.valid.to(imp.dtype)
        if imp.dtype == torch.bfloat16:
            # XLA's bf16 logistic: 1 / (1 + exp(-x)), each op rounded
            gate = 1 / (1 + torch.exp(-imp))
        else:
            gate = torch.sigmoid(imp)
        gated = feat * gate[..., None]
        k = min(self.top_k, st.features.shape[1])
        score = torch.where(st.valid, gate, float("-inf"))
        top, idx = top_k_stable(score, k)
        new = SparseTensor(
            features=torch.gather(gated, 1,
                                  idx[..., None].expand(-1, -1,
                                                        gated.shape[-1])),
            coords=torch.gather(st.coords, 1, idx[..., None].expand(-1, -1,
                                                                    3)),
            valid=torch.gather(st.valid, 1, idx) & torch.isfinite(top),
            spatial_shape=st.spatial_shape)
        return new, imp
