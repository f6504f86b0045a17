"""Anchor-target assignment for the dense heads (detection/target_assign.py;
pcdet AxisAlignedTargetAssigner): per-class IoU matching with matched /
unmatched thresholds, forced matching of each GT's best anchor, residual
regression targets.

Every anchor is assigned at once against the padded GT slots of every batch
item: the (B, N, G) IoU is masked by class agreement and GT validity."""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import boxes3d
from .anchors import AnchorClassConfig, generate_anchors
from .box_coders import ResidualCoder


@dataclasses.dataclass(frozen=True)
class AnchorSet:
    """Static interleaved anchor data (numpy, build time). Per BEV location
    the order is class-major, then (size, rotation): the channel layout the
    1x1 conv heads emit. One bottom height per class."""
    anchors: np.ndarray            # (N, 7) float32
    class_ids: np.ndarray          # (N,) int32, 1-based
    matched_thr: np.ndarray        # (N,) float32
    unmatched_thr: np.ndarray      # (N,) float32
    num_per_loc: int               # sum over classes of S*R
    fmap_size: Tuple[int, int]     # (H=ny, W=nx)


def build_anchor_set(configs: Sequence[AnchorClassConfig],
                     grid_size: Tuple[int, int],
                     point_cloud_range: Sequence[float]) -> AnchorSet:
    per_class, num_per_loc = generate_anchors(configs, grid_size,
                                              point_cloud_range)
    fx = grid_size[0] // configs[0].feature_map_stride
    fy = grid_size[1] // configs[0].feature_map_stride
    loc = fy * fx
    blocks, cids, mts, uts = [], [], [], []
    for i, (cfg, a, n) in enumerate(zip(configs, per_class, num_per_loc)):
        if len(cfg.anchor_bottom_heights) != 1:
            raise ValueError("the interleaved head layout needs one bottom "
                             "height per class")
        if a.shape[0] != loc * n:
            raise ValueError(f"anchors {a.shape} for {loc} locations x {n}")
        blocks.append(a.reshape(loc, n, 7))
        cids.append(np.full((loc, n), i + 1, np.int32))
        mts.append(np.full((loc, n), cfg.matched_threshold, np.float32))
        uts.append(np.full((loc, n), cfg.unmatched_threshold, np.float32))
    return AnchorSet(
        anchors=np.concatenate(blocks, 1).reshape(-1, 7),
        class_ids=np.concatenate(cids, 1).reshape(-1),
        matched_thr=np.concatenate(mts, 1).reshape(-1),
        unmatched_thr=np.concatenate(uts, 1).reshape(-1),
        num_per_loc=sum(num_per_loc), fmap_size=(fy, fx))


_ON_DEVICE: Dict[tuple, tuple] = {}


def anchor_tensor(anchor_set: AnchorSet, field: str,
                  device) -> torch.Tensor:
    """``anchor_set.<field>`` as a tensor on ``device``, made once per
    anchor set."""
    key = (id(anchor_set), field, str(device))
    owner, t = _ON_DEVICE.get(key, (None, None))
    if owner is not anchor_set:
        if len(_ON_DEVICE) > 256:
            _ON_DEVICE.clear()
        t = torch.from_numpy(getattr(anchor_set, field)).to(device)
        _ON_DEVICE[key] = (anchor_set, t)
    return t


def assign_targets(anchor_set: AnchorSet, coder: ResidualCoder,
                   gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                   gt_valid: torch.Tensor, match_height: bool = False,
                   norm_by_num_examples: bool = False):
    """Assign padded GTs to anchors.

    gt_boxes (B, G, 7), gt_classes (B, G) 1-based, gt_valid (B, G) ->
    labels (B, N) int32 (-1 ignore, 0 background, else the class id),
    reg_targets (B, N, code_size), reg_weights (B, N)."""
    dev = gt_boxes.device
    anchors = anchor_tensor(anchor_set, "anchors", dev)
    a_cls = anchor_tensor(anchor_set, "class_ids", dev)
    mthr = anchor_tensor(anchor_set, "matched_thr", dev)
    uthr = anchor_tensor(anchor_set, "unmatched_thr", dev)

    if match_height:
        iou = torch.stack([boxes3d.boxes_iou3d(anchors, g) for g in gt_boxes])
    else:
        iou = boxes3d.boxes3d_nearest_bev_iou(anchors, gt_boxes)   # (B,N,G)
    cand = gt_valid[:, None, :] & (gt_classes[:, None, :]
                                   == a_cls[None, :, None])
    iou = torch.where(cand, iou, torch.full_like(iou, -1.0))

    a2g_max, a2g_arg = iou.max(dim=2)                           # (B, N)
    g_max = iou.max(dim=1).values                               # (B, G)
    # forced: the anchor reaches some valid GT's per-class maximum (> 0)
    forced = ((iou == g_max[:, None, :]) & cand
              & (g_max > 0)[:, None, :]).any(dim=2)

    matched_cls = torch.gather(gt_classes, 1, a2g_arg).to(torch.int32)
    labels = torch.full(a2g_max.shape, -1, dtype=torch.int32, device=dev)
    labels = torch.where(a2g_max < uthr, torch.zeros_like(labels), labels)
    labels = torch.where(a2g_max >= mthr, matched_cls, labels)
    labels = torch.where(forced, matched_cls, labels)

    fg = labels > 0
    matched = torch.gather(gt_boxes, 1, a2g_arg[..., None].expand(-1, -1, 7))
    reg_targets = coder.encode(matched, anchors[None])
    reg_targets = reg_targets * fg[..., None].to(reg_targets.dtype)

    reg_weights = fg.to(torch.float32)
    if norm_by_num_examples:
        num = (labels >= 0).sum(dim=1, keepdim=True).to(torch.float32)
        reg_weights = reg_weights / num.clamp(min=1.0)
    return labels, reg_targets, reg_weights
