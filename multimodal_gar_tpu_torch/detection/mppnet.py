"""MPPNet: multi-frame proposal trajectory refinement, and its E2E variant
with a memory bank (detection/mppnet.py; pcdet detectors/mppnet.py,
roi_heads/mppnet_head.py, model_utils/mppnet_utils.py and
mppnet_memory_bank_e2e.py).

Given per-frame proposals linked into trajectories (``generate_trajectory``:
velocity propagation and IoU >= 0.5 matching), the head crops each
frame's points in the enlarged trajectory boxes (``roipoint_pool3d``,
invalid points parked at 1e6), stamps them with 0.1 x the frame index,
encodes them by their spherical offsets to the box's corners and centre
(the GEOMETRY stream), pools them onto a 4^3 proxy grid per (frame, box)
by a two-radius ball query, adds the MOTION stream (the proxies' offsets
to the current-frame box and the time), and runs a grouped transformer:
group i takes frames i, i + G, ...; each encoder layer mixes the proxy
grid per axis, summarises it into a group token by attention and, on all
but the last layer, cross-attends every group to a fusion of all groups.
A PointNet over the canonical box sequence adds an auxiliary regression;
the heads are a class logit per layer (group 0's token), a box residual
per layer and group, and the joint regression from all group tokens and
the box feature.

The E2E detector threads the bank of past steps' current-frame proxy
geometry features as state in and state out; online (fewer frames of
points than of trajectory) only the current frame is cropped and the past
frames read the bank, never-written slots (``memory_valid`` False)
repeating the current frame's features, as do the offline path's
trajectory-invalid frames. Attention is written out as matmul and softmax
(models/layers.py: MultiHeadAttention), in flax's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import (MaskedBatchNorm, MultiHeadAttention,
                             draw, linear)
from ..ops import boxes3d
from ..ops.geometry import rotate_points_along_z, safe_sqrt
from ..ops.neighbor import ball_query, grouping_operation
from .box_coders import ResidualCoder
from .detectors import DetectorConfig, register_detector
from .post import post_processing
from .roi_heads import (canonical_gt_transform, decode_roi_boxes,
                        roi_box_loss, roi_cls_loss)


@dataclasses.dataclass(frozen=True)
class MPPNetConfig:
    num_frames: int = 4
    num_groups: int = 4                  # G | num_frames; groups interleave
    points_per_roi: int = 128            # cropped points per (frame, RoI)
    proxy_grid: int = 4                  # 4^3 = 64 proxy points per frame
    hidden: int = 64
    num_heads: int = 4
    num_layers: int = 2                  # encoder layers
    mixer_hidden: int = 16
    pool_radii: Tuple[float, ...] = (0.8, 1.6)
    pool_nsamples: Tuple[int, ...] = (16, 16)
    pool_extra_width: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    aux_weight: float = 1.0              # per-layer point / box aux losses
    traj_iou_thresh: float = 0.5         # generate_trajectory matching


def corner_proxy_points(rois: torch.Tensor) -> torch.Tensor:
    """(R, 7) -> (R, 9, 3): the 8 corners and the centre."""
    return torch.cat([boxes3d.boxes_to_corners_3d(rois), rois[:, None, :3]],
                     dim=1)


def dense_proxy_points(rois: torch.Tensor, grid: int) -> torch.Tensor:
    """(R, 7) -> (R, grid^3, 3) global grid points, x slowest."""
    g = torch.arange(grid, dtype=rois.dtype, device=rois.device)
    gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
    idx = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    local = (idx[None] + 0.5) / grid * rois[:, None, 3:6] \
        - rois[:, None, 3:6] / 2
    return rotate_points_along_z(local, rois[:, 6]) + rois[:, None, :3]


def spherical_coordinate(offsets: torch.Tensor,
                         diag: torch.Tensor) -> torch.Tensor:
    """Cartesian offsets -> (r / diag, cos(theta), sin(phi))."""
    x, y, z = offsets.unbind(-1)
    r = safe_sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / torch.clamp(r, min=1e-6), -1, 1))
    phi = torch.atan2(y, x)
    return torch.stack([r / torch.clamp(diag, min=1e-6), torch.cos(theta),
                        torch.sin(phi)], -1)


def proposal_aware_feature(points_xyz: torch.Tensor,
                           rois: torch.Tensor) -> torch.Tensor:
    """Spherical offsets of (R, K, 3) points to their box's 9 proxy points
    -> (R, K, 27)."""
    proxies = corner_proxy_points(rois)
    diag = safe_sqrt((rois[:, 3:6] ** 2).sum(-1))
    off = points_xyz[:, :, None, :] - proxies[:, None, :, :]
    sph = spherical_coordinate(off, diag[:, None, None])
    return sph.reshape(points_xyz.shape[0], points_xyz.shape[1], 27)


class MLPStack(nn.Module):
    """mppnet_utils.MLP: ``num_layers`` Linear layers, ReLU between."""

    def __init__(self, cin: int, hidden: int, out: int, num_layers: int = 3,
                 *, device, generator):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"fc{i}", linear(cin, out if last else hidden,
                                             device=device,
                                             generator=generator))
            cin = hidden

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.num_layers - 1}")(x)


def _layer_norm(dim: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6, device=device)      # flax's epsilon


class FFNBlock(nn.Module):
    """mppnet_utils.FFN: LN(tgt + tgt_input), a 2 x hidden feedforward,
    LN of the residual."""

    def __init__(self, dim: int, hidden: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = _layer_norm(dim, device)
        self.ff1 = linear(dim, hidden * 2, **kw)
        self.ff2 = linear(hidden * 2, dim, **kw)
        self.ln2 = _layer_norm(dim, device)

    def forward(self, tgt: torch.Tensor, tgt_input: torch.Tensor):
        tgt = self.ln1(tgt + tgt_input)
        return self.ln2(tgt + self.ff2(F.relu(self.ff1(tgt))))


class SpatialMixerBlock(nn.Module):
    """Per-axis MLP mixer over the proxy grid (mppnet_utils:109-154):
    (..., grid^3, C) tokens in (x, y, z) scan order."""

    def __init__(self, grid: int, mixer_hidden: int, dim: int, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.grid = grid
        for name in ("mix_x", "mix_y", "mix_z"):
            self.add_module(name, MLPStack(grid, mixer_hidden, grid, 3, **kw))
            self.add_module(f"{name}_ln", _layer_norm(dim, device))
        self.ffn1 = linear(dim, 2 * dim, **kw)
        self.ffn2 = linear(2 * dim, dim, **kw)
        self.ffn_ln = _layer_norm(dim, device)

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        g, c = self.grid, src.shape[-1]
        lead = src.shape[:-2]
        x = src.reshape(lead + (g, g, g, c))
        for ax, name in zip(range(len(lead), len(lead) + 3),
                            ("mix_x", "mix_y", "mix_z")):
            mixed = getattr(self, name)(x.movedim(ax, -1))   # (..., C, g)
            x = getattr(self, f"{name}_ln")(x + mixed.movedim(-1, ax))
        x = x.reshape(lead + (g ** 3, c))
        return self.ffn_ln(x + self.ffn2(F.relu(self.ffn1(x))))


class PointNetSeq(nn.Module):
    """mppnet_utils.PointNet over the canonical box sequence: pointwise
    Linear + masked BN (momentum 0.99, eps 1e-3) + ReLU to 4 x hidden, max
    over T -> (box_reg (N, 7), box_feat (N, 4 x hidden))."""

    def __init__(self, hidden: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        cin = 8
        for i, ch in enumerate((hidden, 2 * hidden, 4 * hidden, 4 * hidden)):
            self.add_module(f"conv{i}", linear(cin, ch, bias=False, **kw))
            self.add_module(f"bn{i}", MaskedBatchNorm(ch, 1e-3, device=device,
                                                      momentum=0.99))
            cin = ch
        self.reg_fc = linear(cin, hidden, **kw)
        self.reg_out = linear(hidden, 7, **kw)
        with torch.no_grad():                   # normal(0.001) as in flax
            self.reg_out.weight.copy_(draw((7, hidden), 0.001, **kw))

    def forward(self, box_seq: torch.Tensor, valid: torch.Tensor):
        h = box_seq
        for i in range(4):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h),
                                        valid[:, None])
            h = F.relu(h)
        feat = h.amax(dim=1)
        return self.reg_out(F.relu(self.reg_fc(feat))), feat


def _attend(att: MultiHeadAttention, q: torch.Tensor,
            kv: torch.Tensor) -> torch.Tensor:
    """flax MultiHeadDotProductAttention over the second-to-last axis of
    (..., Lq, D) queries and (..., Lk, D) keys / values."""
    lead = q.shape[:-2]
    out = att(q.reshape((-1,) + q.shape[-2:]),
              kv.reshape((-1,) + kv.shape[-2:]))
    return out.reshape(lead + out.shape[-2:])


class GroupedEncoderLayer(nn.Module):
    """mppnet_utils.TransformerEncoderLayer.forward_post (:302-345):
    tokens (G, N, 1, H), points (G, N, P, H)."""

    def __init__(self, cfg: MPPNetConfig, groups: int, last: bool, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h = cfg.hidden
        self.last, self.groups = last, groups
        self.mixer = SpatialMixerBlock(cfg.proxy_grid, cfg.mixer_hidden, h,
                                       **kw)
        self.token_att = MultiHeadAttention(h, cfg.num_heads, **kw)
        self.tok_ln1 = _layer_norm(h, device)
        self.tok_ff1 = linear(h, 2 * h, **kw)
        self.tok_ff2 = linear(2 * h, h, **kw)
        self.tok_ln2 = _layer_norm(h, device)
        if not last:
            # inter-group fusion; ONE FFN shared across the groups'
            # cross-attention (mppnet_utils.py:325-341)
            self.fusion_all = MLPStack(groups * h, h, h, 4, **kw)
            self.ffn = FFNBlock(h, 2 * h, **kw)
            for i in range(groups):
                self.add_module(f"cross{i}", MultiHeadAttention(
                    h, cfg.num_heads, **kw))

    def forward(self, tokens: torch.Tensor, points: torch.Tensor):
        mixed = self.mixer(points)
        tokens = self.tok_ln1(tokens + _attend(self.token_att, tokens, mixed))
        tokens = self.tok_ln2(tokens + self.tok_ff2(F.relu(self.tok_ff1(
            tokens))))
        if self.last:
            return tokens, mixed
        fused = self.fusion_all(torch.cat(list(mixed), -1))     # (N, P, H)
        outs = [self.ffn(mixed[i], _attend(getattr(self, f"cross{i}"),
                                           mixed[i], fused))
                for i in range(self.groups)]
        return tokens, torch.stack(outs, 0)


class MPPNetHead(nn.Module):
    """The grouped-transformer trajectory refinement head."""

    def __init__(self, cfg: MPPNetConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c = self.cfg = cfg
        h = c.hidden
        t = c.num_frames
        grp = self.groups = min(c.num_groups, t)
        if t % grp:
            raise ValueError(f"{t} frames in {grp} groups")
        nrad = len(c.pool_radii)
        self.up_dim_geometry = MLPStack(29, 64, h // nrad, 3, **kw)
        for i in range(nrad):
            self.add_module(f"pool_mlp{i}", linear(3 + h // nrad, h // nrad,
                                                   bias=False, **kw))
            self.add_module(f"pool_bn{i}", MaskedBatchNorm(
                h // nrad, 1e-3, device=device, momentum=0.99))
        self.up_dim_motion = MLPStack(30, 64, h, 3, **kw)
        if t // grp > 1:
            self.fusion_all_group = MLPStack(t // grp * h, h, h, 4, **kw)
            self.fusion_norm = FFNBlock(h, 2 * h, **kw)
        self.group_tokens = nn.Parameter(torch.zeros((grp, 1, 1, h),
                                                     device=device))
        for i in range(c.num_layers):
            self.add_module(f"enc{i}", GroupedEncoderLayer(
                c, grp, i == c.num_layers - 1, **kw))
        self.seqboxembed = PointNetSeq(h, **kw)
        self.class_embed = linear(h, 1, **kw)
        for g in range(grp):
            self.add_module(f"bbox_embed{g}", MLPStack(h, h, 7, 4, **kw))
        self.jointembed = MLPStack(grp * h + 4 * h, h, 7, 4, **kw)

    def _proxy_geometry(self, frame_points, point_valid, rois, live_mask,
                        proxies):
        """Crop, encode and pool one set of frames: frame_points (B, Tp,
        N, 4), rois (B, Tp, R, 7), proxies (B * Tp * R, P, 3) -> proxy
        geometry features (B, Tp, R, P, H)."""
        c = self.cfg
        b, t_pts = frame_points.shape[:2]
        r = rois.shape[2]
        enlarged = boxes3d.enlarge_box3d(rois, c.pool_extra_width)
        park = torch.where(point_valid[..., None], frame_points[..., :3],
                           1e6)
        pooled, empty = boxes3d.roipoint_pool3d(
            park, frame_points[..., 3:], enlarged,
            num_sampled_points=c.points_per_roi)      # (B, Tp, R, K, 4)
        # time channel (crop_*_frame_points: src[..., 4] = i * 0.1)
        tstamp = 0.1 * torch.arange(t_pts, dtype=pooled.dtype,
                                    device=pooled.device)
        pooled = torch.cat([pooled, tstamp[None, :, None, None, None]
                            .expand(pooled.shape[:-1] + (1,))], -1)
        live = (~empty) & live_mask                           # (B, Tp, R)
        pooled = pooled * live[..., None, None].to(pooled.dtype)

        btp, k = b * t_pts * r, c.points_per_roi
        pts = pooled.reshape(btp, k, -1)
        geo = torch.cat([proposal_aware_feature(pts[..., :3],
                                                rois.reshape(btp, 7)),
                         pts[..., 3:]], -1)                   # (BTpR, K, 29)
        geo = self.up_dim_geometry(geo)
        xyz = pts[..., :3]
        pvalid = live.reshape(btp, 1).expand(btp, k)
        scales = []
        for i, (rad, ns) in enumerate(zip(c.pool_radii, c.pool_nsamples)):
            idx, qempty = ball_query(rad, ns, xyz, proxies, pvalid)
            gx = grouping_operation(xyz, idx) - proxies[:, :, None, :]
            h = torch.cat([gx, grouping_operation(geo, idx)], -1)
            h = getattr(self, f"pool_bn{i}")(getattr(self, f"pool_mlp{i}")(h),
                                             pvalid[:, :1, None])
            h = F.relu(h).amax(dim=2)
            scales.append(h * (~qempty)[..., None].to(h.dtype))
        return torch.cat(scales, -1).reshape(b, t_pts, r, -1, c.hidden)

    def forward(self, frame_points: torch.Tensor, point_valid: torch.Tensor,
                trajectory_rois: torch.Tensor, roi_valid: torch.Tensor,
                traj_valid: Optional[torch.Tensor] = None,
                geo_memory: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """frame_points (B, T_pts, N, 4) (current frame first; T_pts == T,
        or 1 online), point_valid (B, T_pts, N), trajectory_rois (B, T, R,
        7), roi_valid (B, R), traj_valid (B, T, R), geo_memory (B, T - 1, R,
        P, H): the past frames' banked proxy geometry features, required
        when T_pts < T."""
        c = self.cfg
        b, t_pts = frame_points.shape[:2]
        t, r = trajectory_rois.shape[1:3]
        grp, glen, p3, hd = self.groups, t // self.groups, c.proxy_grid ** 3, \
            c.hidden
        if t != c.num_frames:
            raise ValueError(f"{t} trajectory frames, configured for "
                             f"{c.num_frames}")
        if traj_valid is None:
            traj_valid = roi_valid[:, None, :].expand(b, t, r)
        proxies_all = dense_proxy_points(trajectory_rois.reshape(-1, 7),
                                         c.proxy_grid)       # (BTR, P, 3)
        proxies = proxies_all.reshape(b, t, r, p3, 3)[:, :t_pts].reshape(
            -1, p3, 3)
        proxy_feat = self._proxy_geometry(
            frame_points, point_valid, trajectory_rois[:, :t_pts],
            traj_valid[:, :t_pts], proxies)
        if t_pts < t:
            # online: past frames from the bank, unmatched or never-written
            # ones repeating the current frame's
            if geo_memory is None or geo_memory.shape[1] != t - 1:
                raise ValueError("the online path needs geo_memory of the "
                                 f"{t - 1} past frames")
            cur = proxy_feat[:, 0]
            past = torch.where(traj_valid[:, 1:, :, None, None], geo_memory,
                               cur[:, None])
            geo_all = torch.cat([proxy_feat, past], 1)
        else:
            # offline: trajectory-invalid frames repeat the current frame's
            geo_all = torch.where(traj_valid[..., None, None], proxy_feat,
                                  proxy_feat[:, :1])

        # motion: the proxies' offsets to the CURRENT box, and the time
        cur_rois = trajectory_rois[:, :1].expand(b, t, r, 7).reshape(-1, 7)
        msph = proposal_aware_feature(proxies_all, cur_rois)
        tch = (0.1 * torch.arange(t, dtype=msph.dtype, device=msph.device))[
            None, :, None, None, None].expand(b, t, r, p3, 1).reshape(
            -1, p3, 1)
        motion = self.up_dim_motion(torch.cat(
            [msph, msph.new_zeros(msph.shape[:-1] + (2,)), tch], -1))
        src = (geo_all.reshape(-1, p3, hd) + motion).reshape(b, t, r, p3, hd)
        src = src * roi_valid[:, None, :, None, None].to(src.dtype)
        frame_summary = src.amax(dim=3)                       # (B, T, R, H)

        # groups: frame l * G + g is group g's l-th
        groups = src.transpose(1, 2).reshape(b * r, glen, grp, p3, hd)
        groups = groups.movedim(2, 0)                         # (G, N, L,P,H)
        if glen > 1:
            merged = groups.movedim(2, -2).reshape(grp, b * r, p3, glen * hd)
            points = self.fusion_norm(groups[:, :, 0],
                                      self.fusion_all_group(merged))
        else:
            points = groups[:, :, 0]
        tokens = self.group_tokens.expand(grp, b * r, 1, hd)
        tok_layers = []
        for i in range(c.num_layers):
            tokens, points = getattr(self, f"enc{i}")(tokens, points)
            tok_layers.append(tokens[:, :, 0])                # (G, N, H)

        # the auxiliary box-sequence branch
        tstamp = (0.1 * torch.arange(t, dtype=trajectory_rois.dtype,
                                     device=trajectory_rois.device))[
            None, :, None, None].expand(b, t, r, 1)
        xyz = trajectory_rois[..., :3] - trajectory_rois[:, :1, :, :3]
        box_seq = torch.cat([xyz, trajectory_rois[..., 3:7], tstamp], -1)
        ry0 = trajectory_rois[:, 0, :, 6].reshape(b * r)
        seq = box_seq.transpose(1, 2).reshape(b * r, t, 8)
        rot = rotate_points_along_z(seq[..., :3], -ry0)
        seq = torch.cat([rot, seq[..., 3:6], torch.zeros_like(seq[..., 6:7]),
                         seq[..., 7:]], -1)
        box_reg, box_feat = self.seqboxembed(seq, roi_valid.reshape(b * r))

        # heads: the class embed shared across layers, a bbox embed per group
        point_cls = torch.stack([self.class_embed(tl[0])[..., 0]
                                 for tl in tok_layers], 0)   # (L, N)
        point_reg = torch.stack([torch.stack(
            [getattr(self, f"bbox_embed{g}")(tl[g]) for g in range(grp)], 0)
            for tl in tok_layers], 0)                          # (L, G, N, 7)
        hs = torch.cat([tok_layers[-1][g] for g in range(grp)], -1)
        joint_reg = self.jointembed(torch.cat([hs, box_feat], -1))
        valid = roi_valid.reshape(b * r).to(joint_reg.dtype)
        return {
            "rcnn_cls": (point_cls[-1] * valid).reshape(b, r),
            "rcnn_cls_layers": point_cls * valid[None],
            "point_reg": point_reg * valid[None, None, :, None],
            "box_reg": (box_reg * valid[:, None]).reshape(b, r, 7),
            "rcnn_reg": (joint_reg * valid[:, None]).reshape(b, r, 7),
            "frame_tokens": frame_summary.transpose(1, 2),     # (B,R,T,H)
            # the current frame's proxy geometry, the E2E bank's entry
            "geo_memory_out": geo_all[:, 0],                   # (B,R,P,H)
        }


class MPPNetDetector(nn.Module):
    """mppnet.py on precomputed per-frame proposals: trajectory refinement
    only (the single-frame detector is any zoo member).
    ``forward(frame_points, point_valid, trajectory_rois, roi_valid,
    traj_valid=None)``."""

    def __init__(self, cfg: DetectorConfig,
                 mp_cfg: MPPNetConfig = MPPNetConfig(), *, device,
                 generator):
        super().__init__()
        self.cfg, self.mp_cfg = cfg, mp_cfg
        self.head = MPPNetHead(mp_cfg, device=device, generator=generator)

    def forward(self, frame_points, point_valid, trajectory_rois, roi_valid,
                traj_valid=None) -> Dict[str, torch.Tensor]:
        out = self.head(frame_points, point_valid, trajectory_rois,
                        roi_valid, traj_valid=traj_valid)
        out["rois"] = trajectory_rois[:, 0]
        out["roi_valid"] = roi_valid
        return out

    def loss(self, preds, gt_boxes, gt_classes, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """IoU-guided confidence per encoder layer + canonical box
        regression of the joint head, with the per-layer per-group and the
        box-sequence auxiliary regressions (mppnet_head.get_loss)."""
        c = self.mp_cfg
        coder = ResidualCoder()
        rois = preds["rois"]
        iou = torch.stack([boxes3d.boxes_iou3d(ro, gt)
                           for ro, gt in zip(rois, gt_boxes)])  # (B, R, G)
        iou = torch.where(gt_valid[:, None, :], iou, 0.0)
        best, arg = iou.max(-1).values, iou.argmax(-1)
        gt_of = torch.gather(gt_boxes, 1, arg[..., None].expand(-1, -1,
                                                                gt_boxes
                                                                .shape[-1]))
        fg, bg = best > c.cls_fg_thresh, best < c.cls_bg_thresh
        soft = (best - c.cls_bg_thresh) / (c.cls_fg_thresh - c.cls_bg_thresh)
        cls_t = torch.where(fg, 1.0, torch.where(bg, 0.0, soft))
        cls_t = torch.where(preds["roi_valid"], cls_t, -1.0).reshape(-1)
        layers = preds["rcnn_cls_layers"]
        cls_loss = sum(roi_cls_loss(layers[i], cls_t)
                       for i in range(layers.shape[0])) / layers.shape[0]
        gt_ct = torch.stack([canonical_gt_transform(ro, g)
                             for ro, g in zip(rois, gt_of)])

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])
        reg_fg = flat((best > 0.55) & preds["roi_valid"])
        args = (flat(rois), flat(gt_ct), flat(gt_of), reg_fg)
        reg = roi_box_loss(coder, flat(preds["rcnn_reg"]), *args)
        pr = preds["point_reg"]                               # (L, G, BR, 7)
        aux = 0.0
        for i in range(pr.shape[0]):
            for g in range(pr.shape[1]):
                aux = aux + roi_box_loss(coder, pr[i, g], *args)[
                    "rcnn_loss_reg_total"]
        aux = (aux + roi_box_loss(coder, flat(preds["box_reg"]), *args)[
            "rcnn_loss_reg_total"]) / (pr.shape[0] * pr.shape[1] + 1)
        return {"rcnn_loss_cls": cls_loss,
                "rcnn_loss_reg": reg["rcnn_loss_reg"],
                "rcnn_loss_aux": aux,
                "loss": cls_loss + reg["rcnn_loss_reg_total"]
                + c.aux_weight * aux}

    def predict(self, preds) -> Dict[str, torch.Tensor]:
        """Decoded refined boxes through the NMS; the class labels ride
        with the input proposals (``preds["roi_labels"]``, 1-based) where
        the caller gives them."""
        b, r = preds["rcnn_cls"].shape
        boxes = decode_roi_boxes(ResidualCoder(),
                                 preds["rcnn_reg"].reshape(b * r, 7),
                                 preds["rois"].reshape(b * r, -1)
                                 ).reshape(b, r, -1)
        scores = torch.sigmoid(preds["rcnn_cls"]) \
            * preds["roi_valid"].to(torch.float32)
        return post_processing(scores[..., None], boxes, self.cfg.nms,
                               cls_preds_normalized=True,
                               valid=preds["roi_valid"],
                               labels=preds.get("roi_labels"))


class MPPNetE2EDetector(MPPNetDetector):
    """mppnet_e2e.py: the online variant, the bank of past steps' current-
    frame proxy geometry features threaded as state (``memory`` (B, T - 1,
    R, P, H) and ``memory_valid`` (B, T - 1, R) in, rolled by one step in
    the output). With as many frames of points as of trajectory the bank
    is not read (offline); with fewer only the current frame is cropped."""

    def forward(self, frame_points, point_valid, trajectory_rois, roi_valid,
                memory: Optional[torch.Tensor] = None, traj_valid=None,
                memory_valid: Optional[torch.Tensor] = None):
        c = self.mp_cfg
        t = trajectory_rois.shape[1]
        b, r = roi_valid.shape
        online = frame_points.shape[1] < t
        if memory is None:
            memory = trajectory_rois.new_zeros(
                (b, t - 1, r, c.proxy_grid ** 3, c.hidden))
            if memory_valid is None:
                memory_valid = torch.zeros((b, t - 1, r), dtype=torch.bool,
                                           device=roi_valid.device)
        elif memory_valid is None:
            # a bank without validity: every slot written
            memory_valid = roi_valid[:, None, :].expand(b, t - 1, r)
        if online and traj_valid is None:
            traj_valid = torch.cat([roi_valid[:, None, :], memory_valid], 1)
        if online:
            out = self.head(frame_points[:, :1], point_valid[:, :1],
                            trajectory_rois, roi_valid, traj_valid=traj_valid,
                            geo_memory=memory)
        else:
            out = self.head(frame_points, point_valid, trajectory_rois,
                            roi_valid, traj_valid=traj_valid)
        out["rois"] = trajectory_rois[:, 0]
        out["roi_valid"] = roi_valid
        out["memory"] = torch.cat([out["geo_memory_out"][:, None],
                                   memory[:, :-1]], 1)
        out["memory_valid"] = torch.cat([roi_valid[:, None, :],
                                         memory_valid[:, :-1]], 1)
        return out


def generate_trajectory(cur_boxes: torch.Tensor, prev_boxes: torch.Tensor,
                        iou_thresh: float = 0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Velocity-propagated trajectory linking (mppnet_head.generate_
    trajectory:635-659): frame i's hypothesis is frame i-1's trajectory box
    advanced by its velocity (columns 7:9 where present); the best-IoU
    proposal of frame i (the first among equals) takes the entry where the
    IoU reaches ``iou_thresh``, else the entry keeps the current-frame box
    and the frame is marked invalid. cur_boxes (R, C >= 7), prev_boxes
    (T - 1, P, C) -> trajectory (T, R, C), valid (T, R) bool."""
    has_vel = cur_boxes.shape[-1] >= 9
    traj, frames, valids = cur_boxes, [cur_boxes], []
    for props in prev_boxes:
        hyp = traj
        if has_vel:
            hyp = torch.cat([traj[:, 0:2] + traj[:, 7:9], traj[:, 2:]], -1)
        iou = boxes3d.boxes_iou3d(hyp[:, :7], props[:, :7])   # (R, P)
        idx = iou.argmax(dim=1)
        matched = iou.max(dim=1).values >= iou_thresh
        traj = torch.where(matched[:, None], props[idx], cur_boxes)
        frames.append(traj)
        valids.append(matched)
    first = torch.ones(cur_boxes.shape[0], dtype=torch.bool,
                       device=cur_boxes.device)
    return torch.stack(frames), torch.stack([first] + valids)


@register_detector("MPPNet")
def _build_mppnet(cfg, **kw):
    return MPPNetDetector(cfg, **kw)


@register_detector("MPPNetE2E")
def _build_mppnet_e2e(cfg, **kw):
    return MPPNetE2EDetector(cfg, **kw)
