"""Dense (BEV) detection heads (detection/dense_heads.py; pcdet
dense_heads/): AnchorHeadSingle with the anchor loss and decode, and
CenterHead with its gaussian targets, loss and top-K decode.

The heads convolve NCHW maps and return their outputs NHWC, the JAX
package's layout: flattening (B, H, W, A * code) to (B, H*W*A, code) then
orders anchors per location class-major, as ``build_anchor_set`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, conv2d
from ..train import loss_lib
from .box_coders import ResidualCoder
from .target_assign import AnchorSet, anchor_tensor, assign_targets


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """pcdet common_utils.limit_period: wrap an angle into one period."""
    return val - torch.floor(val / period + offset) * period


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Anchor head
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnchorHeadConfig:
    num_class: int = 3
    use_direction_classifier: bool = True
    num_dir_bins: int = 2
    dir_offset: float = 0.78539          # pi/4
    dir_limit_offset: float = 0.0
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    dir_weight: float = 0.2
    code_weights: Tuple[float, ...] = (1.0,) * 7
    match_height: bool = False
    norm_by_num_examples: bool = False
    encode_angle_by_sincos: bool = False


class AnchorHeadSingle(nn.Module):
    """1x1-conv anchor head over an NCHW BEV map
    (anchor_head_single.py:41-75); outputs NHWC."""

    def __init__(self, cin: int, cfg: AnchorHeadConfig,
                 num_anchors_per_loc: int, code_size: int = 7, *, device,
                 generator):
        super().__init__()
        a = num_anchors_per_loc
        kw = dict(bias=True, device=device, generator=generator)
        # focal-init bias pi = 0.01 (anchor_head_single.py:36-39)
        self.conv_cls = conv2d(cin, a * cfg.num_class, 1,
                               bias_value=-float(np.log((1 - 0.01) / 0.01)),
                               **kw)
        self.conv_box = conv2d(cin, a * code_size, 1, std=0.001, **kw)
        self.conv_dir_cls = conv2d(cin, a * cfg.num_dir_bins, 1, **kw) \
            if cfg.use_direction_classifier else None

    def forward(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"cls_preds": _nhwc(self.conv_cls(bev)),
               "box_preds": _nhwc(self.conv_box(bev))}
        if self.conv_dir_cls is not None:
            out["dir_cls_preds"] = _nhwc(self.conv_dir_cls(bev))
        return out


def _flat(x: torch.Tensor, last: int) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, last)


def anchor_head_loss(preds: Dict[str, torch.Tensor], anchor_set: AnchorSet,
                     coder: ResidualCoder, cfg: AnchorHeadConfig,
                     gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                     gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RPN loss (anchor_head_template.py:101-223): focal classification +
    smooth-L1 location (+ direction CE); gt_* are (B, G, ...)."""
    labels, reg_targets, _ = assign_targets(
        anchor_set, coder, gt_boxes, gt_classes, gt_valid,
        match_height=cfg.match_height,
        norm_by_num_examples=cfg.norm_by_num_examples)
    b = labels.shape[0]
    cls_preds = _flat(preds["cls_preds"], cfg.num_class)
    box_preds = _flat(preds["box_preds"], coder.full_code_size)

    cared = labels >= 0
    positives = labels > 0
    pos_norm = positives.sum(1, keepdim=True).to(torch.float32).clamp(min=1.0)
    cls_weights = cared.to(torch.float32) / pos_norm
    reg_w = positives.to(torch.float32) / pos_norm

    one_hot = F.one_hot(torch.where(cared, labels, 0).long(),
                        cfg.num_class + 1)[..., 1:].to(cls_preds.dtype)
    cls_loss = loss_lib.sigmoid_focal_loss(
        cls_preds, one_hot, cls_weights).sum() / b * cfg.cls_weight

    anchors = anchor_tensor(anchor_set, "anchors", gt_boxes.device)
    if not cfg.encode_angle_by_sincos:
        # sin(a - b) decomposition of the heading residual
        pr, tr = box_preds[..., 6:7], reg_targets[..., 6:7]
        box_preds_s = torch.cat([box_preds[..., :6],
                                 torch.sin(pr) * torch.cos(tr),
                                 box_preds[..., 7:]], dim=-1)
        reg_targets_s = torch.cat([reg_targets[..., :6],
                                   torch.cos(pr) * torch.sin(tr),
                                   reg_targets[..., 7:]], dim=-1)
    else:
        box_preds_s, reg_targets_s = box_preds, reg_targets
    code_w = torch.tensor(cfg.code_weights[:box_preds_s.shape[-1]],
                          dtype=box_preds.dtype, device=box_preds.device)
    loc = loss_lib.smooth_l1_loss(box_preds_s * code_w,
                                  reg_targets_s * code_w, reg_w)
    losses = {"rpn_loss_cls": cls_loss,
              "rpn_loss_loc": loc.sum() / b * cfg.loc_weight}

    if cfg.use_direction_classifier and "dir_cls_preds" in preds:
        rot_gt = reg_targets[..., 6] + anchors[None, :, 6]
        offset_rot = limit_period(rot_gt - cfg.dir_offset, 0, 2 * np.pi)
        dir_t = (offset_rot / (2 * np.pi / cfg.num_dir_bins)).to(
            torch.int32).clamp(0, cfg.num_dir_bins - 1)
        dir_logits = _flat(preds["dir_cls_preds"], cfg.num_dir_bins)
        w = positives.to(torch.float32)
        w = w / w.sum(-1, keepdim=True).clamp(min=1.0)
        losses["rpn_loss_dir"] = loss_lib.weighted_cross_entropy(
            dir_logits, F.one_hot(dir_t.long(), cfg.num_dir_bins).to(
                dir_logits.dtype), w).sum() / b * cfg.dir_weight
    losses["rpn_loss"] = sum(losses.values())
    return losses


def decode_anchor_preds(preds: Dict[str, torch.Tensor], anchor_set: AnchorSet,
                        coder: ResidualCoder, cfg: AnchorHeadConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls logits (B, N, num_class), boxes (B, N, 7)):
    anchor_head_template.generate_predicted_boxes."""
    cls_preds = _flat(preds["cls_preds"], cfg.num_class)
    box_preds = _flat(preds["box_preds"], coder.full_code_size)
    anchors = anchor_tensor(anchor_set, "anchors", box_preds.device)
    boxes = coder.decode(box_preds, anchors[None])
    if cfg.use_direction_classifier and "dir_cls_preds" in preds:
        dir_labels = _flat(preds["dir_cls_preds"], cfg.num_dir_bins).argmax(-1)
        period = 2 * np.pi / cfg.num_dir_bins
        dir_rot = limit_period(boxes[..., 6] - cfg.dir_offset,
                               cfg.dir_limit_offset, period)
        heading = dir_rot + cfg.dir_offset + period * dir_labels.to(
            boxes.dtype)
        boxes = torch.cat([boxes[..., :6], heading[..., None],
                           boxes[..., 7:]], dim=-1)
    return cls_preds, boxes


# ---------------------------------------------------------------------------
# CenterPoint head
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CenterHeadConfig:
    class_names: Tuple[str, ...] = ("Car", "Pedestrian", "Cyclist")
    shared_conv_channels: int = 64
    num_hm_conv: int = 2
    feature_map_stride: int = 8
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    code_weights: Tuple[float, ...] = (1., 1., 1., 1., 1., 1., 1., 1.)
    max_objs: int = 500
    # regression target channels: center(2) center_z(1) dim(3) rot(2)
    head_order: Tuple[str, ...] = ("center", "center_z", "dim", "rot")
    head_dims: Tuple[int, ...] = (2, 1, 3, 2)


class CenterHead(nn.Module):
    """CenterPoint head (center_head.py): shared 3x3 conv + BN (flax
    defaults: eps 1e-5, momentum 0.99) + ReLU, then one conv branch per
    output; a single task group over all classes. Outputs NHWC maps."""

    def __init__(self, cin: int, cfg: CenterHeadConfig, *, device,
                 generator):
        super().__init__()
        self.cfg = cfg
        ch = cfg.shared_conv_channels
        kw = dict(device=device, generator=generator)
        self.shared_conv = conv2d(cin, ch, 3, 1, 1, **kw)
        self.shared_bn = BatchNorm(ch, 1e-5, device=device, momentum=0.99,
                                   channel_axis=1)
        self.branches = [("hm", len(cfg.class_names), cfg.num_hm_conv)] + [
            (nm, d, 2) for nm, d in zip(cfg.head_order, cfg.head_dims)]
        for name, out_ch, n_conv in self.branches:
            for i in range(n_conv - 1):
                self.add_module(f"{name}_conv{i}",
                                conv2d(ch, ch, 3, 1, 1, bias=True, **kw))
            self.add_module(f"{name}_out", conv2d(
                ch, out_ch, 3, 1, 1, bias=True,
                bias_value=-2.19 if name == "hm" else 0.0, **kw))

    def forward(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.shared_bn(self.shared_conv(bev)))
        out = {}
        for name, _, n_conv in self.branches:
            h = x
            for i in range(n_conv - 1):
                h = F.relu(getattr(self, f"{name}_conv{i}")(h))
            out[name] = _nhwc(getattr(self, f"{name}_out")(h))
        return out


def _gaussian_radius(height, width, min_overlap: float):
    """centernet_utils.gaussian_radius: the least of three IoU-bound roots."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0.0))) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def gaussian_heatmap_targets(cfg: CenterHeadConfig,
                             grid_size: Tuple[int, int],
                             voxel_size: Sequence[float],
                             pc_range: Sequence[float],
                             gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                             gt_valid: torch.Tensor):
    """CenterNet targets, batched: each GT draws a radius-truncated
    gaussian over the whole map, and the heatmap is the max over GTs.

    gt_* (B, G, ...) -> heatmap (B, H, W, C), reg_targets (B, G, 8), inds
    (B, G) flat y * W + x, mask (B, G)."""
    fy = grid_size[1] // cfg.feature_map_stride
    fx = grid_size[0] // cfg.feature_map_stride
    vx = voxel_size[0] * cfg.feature_map_stride
    vy = voxel_size[1] * cfg.feature_map_stride
    dev = gt_boxes.device

    cx = (gt_boxes[..., 0] - pc_range[0]) / vx
    cy = (gt_boxes[..., 1] - pc_range[1]) / vy
    xi = cx.to(torch.int32).clamp(0, fx - 1)
    yi = cy.to(torch.int32).clamp(0, fy - 1)
    in_map = (cx >= 0) & (cx < fx) & (cy >= 0) & (cy < fy)
    mask = gt_valid & in_map & (gt_boxes[..., 3] > 0) & (gt_boxes[..., 4] > 0)

    radius = _gaussian_radius(gt_boxes[..., 4] / vy, gt_boxes[..., 3] / vx,
                              cfg.gaussian_overlap)
    radius = radius.to(torch.int32).clamp(min=cfg.min_radius)

    ys = torch.arange(fy, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(fx, dtype=torch.float32, device=dev)[None, :]
    xf = xi.to(torch.float32)[..., None, None]
    yf = yi.to(torch.float32)[..., None, None]
    r = radius[..., None, None]
    sigma = (2 * r.to(torch.float32) + 1) / 6.0
    d2 = (ys - yf) ** 2 + (xs - xf) ** 2                        # (B,G,H,W)
    g = torch.exp(-d2 / (2 * sigma ** 2))
    trunc = ((ys - yf).abs() <= r) & ((xs - xf).abs() <= r)
    gmaps = torch.where(trunc & mask[..., None, None], g,
                        torch.zeros_like(g))
    onehot = F.one_hot((gt_classes.long() - 1).clamp(min=0),
                       len(cfg.class_names)).to(torch.float32)
    onehot = onehot * (gt_classes >= 1)[..., None].to(torch.float32)
    heatmap = (gmaps[..., None] * onehot[:, :, None, None, :]).amax(dim=1)

    reg = torch.cat([
        (cx - xi.to(cx.dtype))[..., None], (cy - yi.to(cy.dtype))[..., None],
        gt_boxes[..., 2:3],
        torch.log(gt_boxes[..., 3:6].clamp(min=1e-5)),
        torch.cos(gt_boxes[..., 6:7]), torch.sin(gt_boxes[..., 6:7])], -1)
    inds = yi * fx + xi
    return heatmap, reg, inds, mask


def center_head_loss(preds: Dict[str, torch.Tensor], cfg: CenterHeadConfig,
                     grid_size, voxel_size, pc_range,
                     gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                     gt_valid: torch.Tensor, denominator=loss_lib.local_count
                     ) -> Dict[str, torch.Tensor]:
    """Heatmap focal loss + gathered L1 regression (center_head.get_loss);
    ``denominator`` turns the positive centres' and the regressed rows'
    counts into their divisors."""
    hm_t, reg_t, inds, mask = gaussian_heatmap_targets(
        cfg, tuple(grid_size), tuple(voxel_size), tuple(pc_range),
        gt_boxes, gt_classes, gt_valid)
    hm_pred = torch.sigmoid(preds["hm"]).clamp(1e-4, 1 - 1e-4)
    hm_loss = loss_lib.gaussian_focal_loss(
        hm_pred, hm_t, denominator=denominator) * cfg.cls_weight

    reg_pred = torch.cat([preds[k] for k in cfg.head_order], dim=-1)
    b, h, w, c = reg_pred.shape
    gathered = torch.gather(reg_pred.reshape(b, h * w, c), 1,
                            inds.long()[..., None].expand(-1, -1, c))
    code_w = torch.tensor(cfg.code_weights[:c], dtype=reg_pred.dtype,
                          device=reg_pred.device)
    l1 = (gathered - reg_t).abs() * code_w
    m = mask[..., None].to(l1.dtype)
    loc_loss = (l1 * m).sum() / denominator(m.sum()) * cfg.loc_weight
    return {"hm_loss": hm_loss, "loc_loss": loc_loss,
            "center_loss": hm_loss + loc_loss}


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def decode_center_preds(preds: Dict[str, torch.Tensor], cfg: CenterHeadConfig,
                        grid_size, voxel_size, pc_range,
                        max_boxes: int = 500):
    """Top-K peak decode (centernet_utils.decode_bbox_from_heatmap):
    (scores (B, K), labels (B, K) 1-based, boxes (B, K, 7))."""
    hm = torch.sigmoid(preds["hm"])
    b, h, w, c = hm.shape
    scores, idx = top_k_stable(hm.reshape(b, h * w * c), max_boxes)
    cls = idx % c
    pix = idx // c
    yi = (pix // w).to(torch.float32)
    xi = (pix % w).to(torch.float32)

    def gather(name):
        f = preds[name].reshape(b, h * w, -1)
        return torch.gather(f, 1, pix[..., None].expand(-1, -1, f.shape[-1]))

    center = gather("center")
    xs = (xi + center[..., 0]) * voxel_size[0] * cfg.feature_map_stride \
        + pc_range[0]
    ys = (yi + center[..., 1]) * voxel_size[1] * cfg.feature_map_stride \
        + pc_range[1]
    zs = gather("center_z")[..., 0]
    dims = torch.exp(gather("dim"))
    rot = gather("rot")
    heading = torch.atan2(rot[..., 1], rot[..., 0])
    boxes = torch.cat([xs[..., None], ys[..., None], zs[..., None], dims,
                       heading[..., None]], dim=-1)
    return scores, (cls + 1).to(torch.int32), boxes
