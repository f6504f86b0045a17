"""MGAR forward (models/mgar.py): RGB + LiDAR backbones, DAFM fusion,
grouping and the action / activity / cardinality heads. ``model.train()``
selects the training forward (batch-statistics BatchNorm, dropout, no
diagonal fill); the frozen I3D stays in eval.

The ported configuration is mil3's: modality Multi, fusion Attention_mat,
sim cosine, euclidean D_embed, social_layer none, ind_action_concat, float32.
Other settings raise at construction.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import (pairwise_cosine_similarity, pairwise_euclidean,
                            pairwise_giou_2d)
from ..ops.grouping import decode_group_ids, group_max_pool
from ..ops.masked import masked_max
from ..types import Batch, ModelOutputs
from ..utils.device import resolve_device
from .fusion import DAFM
from .layers import HeadMLP, MaskedBatchNorm, linear
from .lidar_backbone import LiDARBackbone
from .rgb_backbone import RGBBackbone

_INTERACTION_WIDTHS = (2, 4, 7, 5)


class GARFusionNet(nn.Module):
    """Fusion + grouping + heads (GAR_Fusion_Net3)."""

    def __init__(self, mcfg, *, device, generator):
        """mcfg: multimodal_gar_tpu_torch.config.ModelConfig."""
        super().__init__()
        f = mcfg.fusion
        if (f.modality != "Multi" or f.fusion != "Attention_mat"
                or f.sim != "cosine" or not f.euclidean
                or f.social_layer != "none" or not f.ind_action_concat
                or f.sg_feat_org):
            raise NotImplementedError(
                "only mil3's fusion settings are ported (Multi, "
                "Attention_mat, cosine, euclidean, social_layer none, "
                "ind_action_concat)")
        self.feat_norm = f.feat_norm
        kw = dict(device=device, generator=generator)
        d_rgb = mcfg.rgb.embedding_dim
        d_lidar = mcfg.lidar.embedding_dim
        if self.feat_norm:
            self.bn_rgb = MaskedBatchNorm(d_rgb, 1e-5, device=device,
                                          momentum=0.9)
            self.bn_lidar = MaskedBatchNorm(d_lidar, 1e-5, device=device,
                                            momentum=0.9)
        self.dafm = DAFM(f.hidden_dim, f.sigma, f.num_fusion_layers, **kw)
        self.D_embed = linear(2, 1, **kw)
        res_dim = d_rgb + d_lidar
        for i in range(3):
            self.add_module(f"pose_head_{i + 1}",
                            HeadMLP(res_dim, 512, 4, "softmax", **kw))
        for i, w in enumerate(_INTERACTION_WIDTHS):
            self.add_module(f"intrctn_head_{i + 1}",
                            HeadMLP(res_dim, 512, w, "sigmoid", **kw))
        for i in range(3):
            self.add_module(f"SG_pose_head_{i + 1}",
                            HeadMLP(f.hidden_dim, 512, 4, "sigmoid", **kw))
        for i, w in enumerate(_INTERACTION_WIDTHS):
            self.add_module(f"SG_intrctn_head_{i + 1}",
                            HeadMLP(f.hidden_dim, 512, w, "sigmoid", **kw))
        self.card_net_0 = linear(f.hidden_dim + 1, 512, **kw)
        self.card_net_1 = linear(512, 1, **kw)

    def _heads(self, prefix: str, count: int, x, vmask):
        return tuple(getattr(self, f"{prefix}_{i + 1}")(x) * vmask
                     for i in range(count))

    def forward(self, rgb, lidar, boxes2d, boxes3d, valid) -> ModelOutputs:
        n = valid.shape[1]
        vmask = valid[..., None].to(rgb.dtype)
        pair_valid = valid[:, None, :] & valid[:, :, None]         # (B, N, N)
        if self.feat_norm:
            rgb = self.bn_rgb(rgb, valid) * vmask
            lidar = self.bn_lidar(lidar, valid) * vmask

        centers3d = boxes3d[..., :3]
        de = pairwise_euclidean(centers3d, zero_diagonal=True) * pair_valid
        dg = pairwise_giou_2d(boxes2d) * pair_valid
        fused = self.dafm(rgb, lidar, de, pair_valid) * vmask

        dv = pairwise_cosine_similarity(fused) * pair_valid
        dvg = torch.stack([dv, dg], dim=-1)                        # (B,N,N,2)
        a_theta = torch.sigmoid(self.D_embed(dvg))[..., 0] * pair_valid
        if not self.training:
            # eval-mode diagonal fill; in training the raw sigmoid diagonal
            # reaches the loss (models/mgar.py:127-131)
            eye = torch.eye(n, dtype=a_theta.dtype,
                            device=a_theta.device)[None]
            a_theta = a_theta * (1.0 - eye) + eye * vmask

        group_ids = decode_group_ids(a_theta, valid)
        sg_features = group_max_pool(fused, group_ids, valid) * vmask
        res_feature = torch.cat([rgb, lidar], dim=-1)

        n_int = len(_INTERACTION_WIDTHS)
        pooled = masked_max(fused, valid[..., None], dim=1)        # (B, D)
        a_sum = torch.sum(a_theta, dim=(1, 2))[:, None]
        card = self.card_net_1(F.relu(self.card_net_0(
            torch.cat([pooled, a_sum], dim=-1))))
        return ModelOutputs(
            a_theta=a_theta,
            pose=self._heads("pose_head", 3, res_feature, vmask),
            interaction=self._heads("intrctn_head", n_int, res_feature, vmask),
            sg_pose=self._heads("SG_pose_head", 3, sg_features, vmask),
            sg_interaction=self._heads("SG_intrctn_head", n_int, sg_features,
                                       vmask),
            card=card, group_ids=group_ids, rgb_features=rgb,
            lidar_features=lidar, fused_features=fused)


class MGAR(nn.Module):
    """Top-level model (GAR_Fusion_ALL): RGB + LiDAR backbones + fusion net.

    Built on ``device`` (the card unless the caller asks for ``"cpu"``;
    without a card the default raises at once) with weights drawn from
    ``generator`` (a CPU generator, seed 0 by default; or load converted JAX
    weights, convert.py); starts in eval mode."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """cfg: multimodal_gar_tpu_torch.config.Config."""
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if cfg.model.dtype != "float32":
            raise NotImplementedError("the port runs float32 only")
        self.image_mean = tuple(cfg.data.image_mean)
        self.image_std = tuple(cfg.data.image_std)
        kw = dict(device=device, generator=generator)
        self.rgb_backbone = RGBBackbone(cfg.model.rgb, **kw)
        self.lidar_backbone = LiDARBackbone(cfg.model.lidar,
                                            cfg.data.point_cloud, **kw)
        self.gar_fusion = GARFusionNet(cfg.model, **kw)
        self.eval()

    def forward(self, batch: Batch) -> ModelOutputs:
        if batch.rulebook is None:
            raise ValueError("the port needs the host rulebook "
                             "(data/rulebook.py) in batch.rulebook")
        images = batch.images
        if images.dtype == torch.uint8:
            # device-side ImageNet normalize of raw frames
            mean = torch.tensor(self.image_mean, device=images.device)
            std = torch.tensor(self.image_std, device=images.device)
            images = images.to(torch.float32) * (1.0 / (255.0 * std)) \
                - mean / std
        rgb = self.rgb_backbone(images, batch.boxes2d, batch.person_valid)
        lidar = self.lidar_backbone(
            batch.voxels, batch.voxel_coords, batch.voxel_num_points,
            batch.voxel_valid, batch.boxes3d, batch.person_valid,
            batch.rulebook)
        return self.gar_fusion(rgb, lidar, batch.boxes2d, batch.boxes3d,
                               batch.person_valid)
