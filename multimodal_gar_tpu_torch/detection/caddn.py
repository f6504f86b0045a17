"""CaDDN: the monocular detector through categorical depth distributions
(detection/caddn.py; pcdet detectors/caddn.py and the ImageVFE stack).

A depth-distribution network (DDN: DeepLabV3 + ResNet101 by default,
detection/ddn_deeplab.py, or a compact conv encoder) gives per-pixel
depth-bin logits and image features; the frustum features are the outer
product of the depth distribution and the channel-reduced features; the
frustum is sampled at the projected voxel centres (``frustum_to_voxel``),
the dense voxel grid collapsed to BEV (Conv2DCollapse), and the standard
BEV trunk and anchor head follow. Depth is supervised by a focal
cross-entropy over the depth bins (ddn_loss.py), with the foreground /
background balancer when a foreground mask is given.

``frustum_to_voxel`` is the JAX package's trilinear gather, not
``F.grid_sample``: each corner's index is clipped into the frustum but its
weight comes from the unclipped corner, so at the borders it takes the
edge value, and out-of-frustum voxels are zeroed by a mask afterwards. It
runs one corner at a time, so that the eight (N, C) gathers are never held
together (at CaDDN.yaml's widths one is 674 MB), and autograd keeps only
each corner's index and weight.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, conv2d
from .bev import Conv2DCollapse, cudnn_autotuned
from .dense_heads import (AnchorHeadSingle, anchor_head_loss,
                          decode_anchor_preds)
from .ddn_deeplab import DeepLabV3DDN
from .detectors import (DetBatch, DetectorConfig, _bev_backbone,
                        _check_dtype, _coder, anchor_set_for,
                        register_detector)
from .post import post_processing


@dataclasses.dataclass(frozen=True)
class CaDDNConfig:
    # "deeplabv3_r101" / "deeplabv3_r50": DDNDeepLabV3 (ddn_deeplab.py);
    # "compact": a small conv encoder with the same contract
    ddn_arch: str = "deeplabv3_r101"
    num_depth_bins: int = 80
    depth_min: float = 2.0
    depth_max: float = 46.8
    disc_mode: str = "LID"               # UD | LID | SID
    downsample_factor: int = 4
    ddn_channels: Tuple[int, ...] = (32, 64, 128)
    channel_reduce: int = 64             # frustum feature channels
    bev_collapse_channels: int = 64
    ddn_loss_weight: float = 3.0
    ddn_alpha: float = 0.25
    ddn_gamma: float = 2.0
    fg_weight: float = 13.0
    bg_weight: float = 1.0


def bin_depths(depth: torch.Tensor, mode: str, depth_min: float,
               depth_max: float, num_bins: int,
               target: bool = False) -> torch.Tensor:
    """Continuous depth -> continuous bin index (transform_utils.
    bin_depths): UD uniform, LID linearly increasing widths, SID log-spaced.
    With ``target`` the floor, clamped into [0, num_bins] int32, non-finite
    indices in bin num_bins (the 'sky' class)."""
    if mode == "UD":
        size = (depth_max - depth_min) / num_bins
        idx = (depth - depth_min) / size
    elif mode == "LID":
        size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        idx = -0.5 + 0.5 * torch.sqrt(
            torch.clamp(1 + 8 * (depth - depth_min) / size, min=0.0))
    elif mode == "SID":
        idx = num_bins * (torch.log(1 + torch.clamp(depth, min=1e-6))
                          - math.log(1 + depth_min)) \
            / (math.log(1 + depth_max) - math.log(1 + depth_min))
    else:
        raise NotImplementedError(mode)
    if target:
        idx = torch.where(torch.isfinite(idx), idx, float(num_bins))
        return torch.clamp(torch.floor(idx), 0, num_bins).to(torch.int32)
    return idx


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NCHW ``x`` padded as flax's "SAME" pads a conv of ``kernel`` at
    ``stride``: out = ceil(in / stride), the extra pixel at the end."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class DDN(nn.Module):
    """The compact depth-distribution network (ddn_template.py contract):
    3 x 3 convs (stride 2 until the downsample factor) + BN (eps 1e-3) +
    ReLU, then 1 x 1 convs to the features and the num_bins + 1 depth
    logits. NHWC in, NHWC out."""

    def __init__(self, cfg: CaDDNConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.strides = []
        cin, stride = 3, 1
        for i, ch in enumerate(cfg.ddn_channels):
            s = 2 if stride < cfg.downsample_factor else 1
            stride *= s
            self.strides.append(s)
            self.add_module(f"conv{i}", conv2d(cin, ch, 3, s, **kw))
            self.add_module(f"bn{i}", BatchNorm(ch, 1e-3, device=device,
                                                momentum=0.99,
                                                channel_axis=1))
            cin = ch
        self.channel_reduce = conv2d(cin, cfg.channel_reduce, 1, bias=True,
                                     **kw)
        self.depth_out = conv2d(cin, cfg.num_depth_bins + 1, 1, bias=True,
                                **kw)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2)
        for i, s in enumerate(self.strides):
            x = _same_pad(x, 3, s)
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return (self.channel_reduce(x).permute(0, 2, 3, 1),
                self.depth_out(x).permute(0, 2, 3, 1))


def frustum_to_voxel(frustum: torch.Tensor, lidar_to_cam: torch.Tensor,
                     cam_to_img: torch.Tensor, image_shape: Tuple[int, int],
                     grid_size: Tuple[int, int, int], pc_range,
                     cfg: CaDDNConfig) -> torch.Tensor:
    """Frustum features (Hf, Wf, D, C) of one item sampled at the projected
    voxel centres -> dense (nz, ny, nx, C): voxel centre -> lidar ->
    camera -> image (u, v) and depth -> feature-map (u, v) (``u / (iw /
    Wf)``) and continuous depth bin -> trilinear gather, zero where the
    centre falls outside the frustum."""
    nx, ny, nz = grid_size
    hf, wf, d, c = frustum.shape
    ih, iw = image_shape
    dev, dt = frustum.device, frustum.dtype
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    vs = (torch.tensor(pc_range[3:6], dtype=torch.float32, device=dev) - lo) \
        / torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
    zz, yy, xx = torch.meshgrid(torch.arange(nz, device=dev),
                                torch.arange(ny, device=dev),
                                torch.arange(nx, device=dev), indexing="ij")
    pts = (torch.stack([xx, yy, zz], -1).to(torch.float32) + 0.5) * vs + lo
    pts = pts.reshape(-1, 3)
    one = torch.ones_like(pts[:, :1])
    cam = (torch.cat([pts, one], -1) @ lidar_to_cam.T)[:, :3]
    img = torch.cat([cam, one], -1) @ cam_to_img.T           # (N, 3)
    depth = img[:, 2]
    safe = torch.where(depth.abs() > 1e-6, depth, 1e-6)
    u, v = img[:, 0] / safe, img[:, 1] / safe
    db = bin_depths(depth, cfg.disc_mode, cfg.depth_min, cfg.depth_max,
                    cfg.num_depth_bins)
    uf = u / (iw / wf)
    vf = v / (ih / hf)
    inb = (depth > 0) & (uf >= 0) & (uf < wf) & (vf >= 0) & (vf < hf) \
        & (db >= 0) & (db < d)
    v0, u0, d0 = (torch.floor(t).to(torch.int64) for t in (vf, uf, db))
    flat = frustum.reshape(-1, c)
    acc = None
    for dv in (0, 1):
        vi = torch.clamp(v0 + dv, 0, hf - 1)
        wv = 1 - (vf - (v0 + dv)).abs()
        for du in (0, 1):
            ui = torch.clamp(u0 + du, 0, wf - 1)
            wu = 1 - (uf - (u0 + du)).abs()
            for dd in (0, 1):
                di = torch.clamp(d0 + dd, 0, d - 1)
                w = torch.clamp(wv * wu * (1 - (db - (d0 + dd)).abs()),
                                0.0, 1.0)
                term = flat.index_select(0, (vi * wf + ui) * d + di) \
                    * w[:, None].to(dt)
                acc = term if acc is None else acc + term
    return (acc * inb[:, None].to(dt)).reshape(nz, ny, nx, c)


class CaDDNDetector(nn.Module):
    """caddn.py: ImageVFE (DDN -> frustum -> voxel) -> Conv2DCollapse ->
    BaseBEVBackbone -> AnchorHeadSingle. ``forward(batch)`` reads the
    batch's images, lidar_to_cam and cam_to_img; its predictions carry the
    depth logits (B, Hf, Wf, D + 1)."""

    def __init__(self, cfg: DetectorConfig, cd_cfg: CaDDNConfig = CaDDNConfig(),
                 *, device, generator):
        super().__init__()
        _check_dtype(cfg)
        self.cfg, self.cd_cfg = cfg, cd_cfg
        kw = dict(device=device, generator=generator)
        cd = cd_cfg
        if cd.ddn_arch.startswith("deeplabv3"):
            backbone = "ResNet50" if cd.ddn_arch.endswith("r50") \
                else "ResNet101"
            self.ffn = DeepLabV3DDN(cd.num_depth_bins + 1, backbone, **kw)
            # DepthFFN's CHANNEL_REDUCE: 1 x 1 (no bias) + BN + ReLU
            self.channel_reduce = conv2d(256, cd.channel_reduce, 1, **kw)
            self.channel_reduce_bn = BatchNorm(cd.channel_reduce, 1e-5,
                                               device=device, momentum=0.9,
                                               channel_axis=1)
        elif cd.ddn_arch == "compact":
            self.ffn = DDN(cd, **kw)
        else:
            raise ValueError(f"unknown ddn_arch {cd.ddn_arch!r}")
        nz = cfg.grid_size[2]
        self.map_to_bev = Conv2DCollapse(nz * cd.channel_reduce,
                                         cd.bev_collapse_channels, **kw)
        self.backbone_2d = _bev_backbone(cfg, cd.bev_collapse_channels, **kw)
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, cfg.head,
            anchor_set_for(cfg).num_per_loc, _coder(cfg).full_code_size,
            **kw)

    def image_features(self, images: torch.Tensor):
        """(frustum features (B, Hf, Wf, D, C), depth logits (B, Hf, Wf,
        D + 1))."""
        cd = self.cd_cfg
        feats, logits = self.ffn(images)
        if hasattr(self, "channel_reduce"):
            f = self.channel_reduce(feats.permute(0, 3, 1, 2))
            feats = F.relu(self.channel_reduce_bn(f)).permute(0, 2, 3, 1)
        probs = torch.softmax(logits, -1)[..., :cd.num_depth_bins]
        return probs[..., :, None] * feats[..., None, :], logits

    def voxel_features(self, frustum: torch.Tensor,
                       batch: DetBatch) -> torch.Tensor:
        """The frustum of each item sampled into the voxel grid, as the
        NCHW BEV input (B, nz * C, ny, nx), channel z * C + c."""
        c = self.cfg
        ih, iw = batch.images.shape[1:3]
        vox = torch.stack([frustum_to_voxel(
            f, l2c, k, (ih, iw), c.grid_size, c.point_cloud_range,
            self.cd_cfg) for f, l2c, k in zip(frustum, batch.lidar_to_cam,
                                              batch.cam_to_img)])
        b, nz, ny, nx, ch = vox.shape
        return vox.permute(0, 1, 4, 2, 3).reshape(b, nz * ch, ny, nx)

    def forward(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        if batch.images is None or batch.lidar_to_cam is None \
                or batch.cam_to_img is None:
            raise ValueError("CaDDN reads the batch's images, lidar_to_cam "
                             "and cam_to_img")
        with cudnn_autotuned():
            frustum, logits = self.image_features(batch.images)
            bev = self.map_to_bev(self.voxel_features(frustum, batch))
            preds = self.dense_head(self.backbone_2d(bev))
        preds["depth_logits"] = logits
        return preds

    def ddn_loss(self, depth_logits: torch.Tensor, depth_maps: torch.Tensor,
                 fg_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Focal cross-entropy over the depth bins (ddn_loss.py:24-75) of
        the GT depth downsampled (nearest) to the logits' map, with the
        fg / bg balancer (balancer.py) where ``fg_mask`` is given."""
        cd = self.cd_cfg
        hf, wf = depth_logits.shape[1:3]
        ih, iw = depth_maps.shape[1:3]
        dev = depth_logits.device
        # the JAX package's float32 products, truncated
        ys = (torch.arange(hf, dtype=torch.float32, device=dev)
              * (ih / hf)).to(torch.int64)
        xs = (torch.arange(wf, dtype=torch.float32, device=dev)
              * (iw / wf)).to(torch.int64)
        d = depth_maps[:, ys][:, :, xs]
        target = bin_depths(d, cd.disc_mode, cd.depth_min, cd.depth_max,
                            cd.num_depth_bins, target=True)
        logp = torch.log_softmax(depth_logits, -1)
        onehot = F.one_hot(target.long(), cd.num_depth_bins + 1).to(
            logp.dtype)
        pt = (onehot * logp.exp()).sum(-1)
        ce = -(onehot * logp).sum(-1)
        focal = cd.ddn_alpha * (1 - pt) ** cd.ddn_gamma * ce
        if fg_mask is not None:
            w = torch.where(fg_mask, cd.fg_weight, cd.bg_weight).to(
                focal.dtype)
            w = w / w.sum().clamp(min=1.0)
            return (focal * w).sum() * cd.ddn_loss_weight
        return focal.mean() * cd.ddn_loss_weight

    def loss(self, preds, batch: DetBatch) -> Dict[str, torch.Tensor]:
        losses = anchor_head_loss(preds, anchor_set_for(self.cfg),
                                  _coder(self.cfg), self.cfg.head,
                                  batch.gt_boxes, batch.gt_classes,
                                  batch.gt_valid)
        if batch.depth_maps is not None:
            losses["ddn_loss"] = self.ddn_loss(preds["depth_logits"],
                                               batch.depth_maps)
            losses["loss"] = losses["rpn_loss"] + losses["ddn_loss"]
        else:
            losses["loss"] = losses["rpn_loss"]
        return losses

    def predict(self, preds) -> Dict[str, torch.Tensor]:
        cls, boxes = decode_anchor_preds(preds, anchor_set_for(self.cfg),
                                         _coder(self.cfg), self.cfg.head)
        return post_processing(cls, boxes, self.cfg.nms)


@register_detector("CaDDN")
def _build_caddn(cfg, in_channels: int = 4, **kw):
    # a camera detector: no point features feed it
    return CaDDNDetector(cfg, **kw)
