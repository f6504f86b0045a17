"""MGAR forward (models/mgar.py): RGB and / or LiDAR backbones, DAFM fusion
(or one of its variants), grouping and the action / activity / cardinality
heads. ``model.train()`` selects the training forward (batch-statistics
BatchNorm, dropout, no diagonal fill); the frozen I3D stays in eval.

Every setting of ``ModelConfig.fusion`` that the JAX ``GARFusionNet`` honours
is honoured here: ``modality`` RGB / LiDAR / Multi, the twelve ``fusion``
names, ``sim`` cosine / Graph / Graph2 / Graph3 / Graph4, ``social_layer``
none / mlp / encoder, ``euclidean``, ``sg_feat_org``, ``ind_action_concat``.
flax infers every layer's input width from its input; here the widths are
computed from the settings.

``model.dtype: bfloat16`` serves as the JAX MGAR does at bf16
(models/mgar.py:189-218): the backbones compute in bf16 (the clips are
rounded to bf16 after the ImageNet normalisation), their features return
to float32, and the fusion net and the heads stay float32. It trains at
bf16 the same way, the parameters float32; a dtype other than float32 or
bfloat16 raises.

While a profiler records, the forward opens program spans
(utils/profiling.py: ``span``): ``mgar.rgb``, ``mgar.lidar`` and
``mgar.fusion`` here, ``fusion.dafm`` and ``fusion.heads`` in
``GARFusionNet``, ``rgb.i3d`` and ``rgb.box_head`` in the RGB branch,
``lidar.vfe``, ``lidar.sparse_backbone``, ``lidar.grid_pool`` and
``lidar.embed`` in the LiDAR branch.
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
from ..utils.profiling import span
from .fusion import DAFM, SocialEncoderLayer, fused_width
from .layers import (HeadMLP, MaskedBatchNorm, cast,
                     compute_dtype, linear)
from .lidar_backbone import LiDARBackbone
from .rgb_backbone import RGBBackbone

_INTERACTION_WIDTHS = (2, 4, 7, 5)
MODALITIES = ("RGB", "LiDAR", "Multi")
SIMS = ("cosine", "Graph", "Graph2", "Graph3", "Graph4")
SOCIAL_LAYERS = ("none", "mlp", "encoder")


class GARFusionNet(nn.Module):
    """Fusion + grouping + heads (GAR_Fusion_Net3). ``rgb`` or ``lidar`` is
    None where the modality leaves that branch out."""

    def __init__(self, mcfg, *, device, generator):
        """mcfg: multimodal_gar_tpu_torch.config.ModelConfig."""
        super().__init__()
        f = mcfg.fusion
        for value, known, what in ((f.modality, MODALITIES, "modality"),
                                   (f.sim, SIMS, "sim"),
                                   (f.social_layer, SOCIAL_LAYERS,
                                    "social_layer")):
            if value not in known:
                raise ValueError(f"unknown {what} {value!r}: one of {known}")
        self.modality, self.sim = f.modality, f.sim
        self.social_layer = f.social_layer if f.sim == "cosine" else "none"
        self.euclidean, self.sg_feat_org = f.euclidean, f.sg_feat_org
        self.ind_action_concat = f.ind_action_concat
        self.feat_norm = f.feat_norm
        kw = dict(device=device, generator=generator)
        d_rgb = mcfg.rgb.embedding_dim if f.modality != "LiDAR" else 0
        d_lidar = mcfg.lidar.embedding_dim if f.modality != "RGB" else 0
        if self.feat_norm:
            # a BatchNorm for each modality present
            if d_rgb:
                self.bn_rgb = MaskedBatchNorm(d_rgb, 1e-5, device=device,
                                              momentum=0.9)
            if d_lidar:
                self.bn_lidar = MaskedBatchNorm(d_lidar, 1e-5, device=device,
                                                momentum=0.9)
        if f.modality == "Multi":
            self.dafm = DAFM(f.hidden_dim, f.sigma, f.num_fusion_layers,
                             f.fusion, **kw)
            d_fused = fused_width(f.fusion, f.hidden_dim)
        else:
            d_fused = d_rgb + d_lidar

        # similarity: Dv for the adjacency head, or a_theta directly
        if self.social_layer == "mlp":
            self.social_layer_0 = linear(d_fused, 256, **kw)
            self.social_layer_1 = linear(256, 128, **kw)
        elif self.social_layer == "encoder":
            self.social_encoder = SocialEncoderLayer(d_fused, **kw)
        if f.sim == "Graph":
            for name in ("sim_phi", "sim_sigma"):
                self.add_module(f"{name}_0", linear(d_fused, 32, **kw))
                self.add_module(f"{name}_1", linear(32, 32, **kw))
        elif f.sim in ("Graph2", "Graph4"):
            self.sim_phi = linear(d_fused + 3, 8, **kw)
            if f.sim == "Graph2":
                self.sim_sigma = linear(d_fused + 3, 8, **kw)
        if f.sim in ("cosine", "Graph"):
            if f.euclidean:
                self.D_embed = linear(2, 1, **kw)
            else:
                self.D_embed_0 = linear(2, 4, **kw)
                self.D_embed_1 = linear(4, 1, **kw)

        res_dim = d_rgb + d_lidar if f.ind_action_concat else 2 * d_fused
        for i in range(3):
            self.add_module(f"pose_head_{i + 1}",
                            HeadMLP(res_dim, 512, 4, "softmax", **kw))
        for i, w in enumerate(_INTERACTION_WIDTHS):
            self.add_module(f"intrctn_head_{i + 1}",
                            HeadMLP(res_dim, 512, w, "sigmoid", **kw))
        for i in range(3):
            self.add_module(f"SG_pose_head_{i + 1}",
                            HeadMLP(d_fused, 512, 4, "sigmoid", **kw))
        for i, w in enumerate(_INTERACTION_WIDTHS):
            self.add_module(f"SG_intrctn_head_{i + 1}",
                            HeadMLP(d_fused, 512, w, "sigmoid", **kw))
        self.card_net_0 = linear(d_fused + 1, 512, **kw)
        self.card_net_1 = linear(512, 1, **kw)

    def _heads(self, prefix: str, count: int, x, vmask):
        return tuple(getattr(self, f"{prefix}_{i + 1}")(x) * vmask
                     for i in range(count))

    def _a_theta(self, fused, dg, boxes3d, pair_valid, vmask):
        """The adjacency matrix before the eval diagonal fill."""
        def outer(a, b):
            return torch.einsum("bnd,bmd->bnm", a, b)
        if self.sim in ("Graph2", "Graph3", "Graph4"):
            # learned similarity on [fused, centre]: a_theta directly
            geo = torch.cat([fused, boxes3d[..., :3]], dim=-1)
            if self.sim == "Graph2":
                phi, sig = self.sim_phi(geo), self.sim_sigma(geo)
                g = outer(phi, sig) + outer(sig, phi)
            elif self.sim == "Graph3":
                g = outer(geo, geo) / geo.shape[-1]
            else:
                phi = self.sim_phi(geo)
                g = outer(phi, phi)
            return torch.sigmoid(g) * pair_valid
        if self.sim == "Graph":
            # phi / sigma bilinear: Dv = phi sigma^T + sigma phi^T
            phi = self.sim_phi_1(F.relu(self.sim_phi_0(fused)))
            sig = self.sim_sigma_1(F.relu(self.sim_sigma_0(fused)))
            dv = (outer(phi, sig) + outer(sig, phi)) * pair_valid
        else:
            sim_in = fused
            if self.social_layer == "mlp":
                sim_in = self.social_layer_1(F.relu(
                    self.social_layer_0(fused))) * vmask
            elif self.social_layer == "encoder":
                sim_in = self.social_encoder(fused, pair_valid) * vmask
            dv = pairwise_cosine_similarity(sim_in) * pair_valid
        dvg = torch.stack([dv, dg], dim=-1)                        # (B,N,N,2)
        if self.euclidean:
            logit = self.D_embed(dvg)
        else:
            logit = self.D_embed_1(F.relu(self.D_embed_0(dvg)))
        return torch.sigmoid(logit)[..., 0] * pair_valid

    def forward(self, rgb: Optional[torch.Tensor],
                lidar: Optional[torch.Tensor], boxes2d, boxes3d, valid
                ) -> ModelOutputs:
        n = valid.shape[1]
        vmask = valid[..., None].to(torch.float32)
        pair_valid = valid[:, None, :] & valid[:, :, None]         # (B, N, N)
        if self.feat_norm:
            if rgb is not None:
                rgb = self.bn_rgb(rgb, valid) * vmask
            if lidar is not None:
                lidar = self.bn_lidar(lidar, valid) * vmask

        centers3d = boxes3d[..., :3]
        de = pairwise_euclidean(centers3d, zero_diagonal=True) * pair_valid
        dg = pairwise_giou_2d(boxes2d) * pair_valid
        if self.modality == "RGB":
            fused = rgb
        elif self.modality == "LiDAR":
            fused = lidar
        else:
            with span("fusion.dafm"):
                fused = self.dafm(rgb, lidar, de, pair_valid,
                                  centers=centers3d[..., :2])
        fused = fused * vmask

        with span("fusion.heads"):
            a_theta = self._a_theta(fused, dg, boxes3d, pair_valid, vmask)
            if not self.training:
                # eval-mode diagonal fill; in training the raw sigmoid
                # diagonal reaches the loss (models/mgar.py:127-131)
                eye = torch.eye(n, dtype=a_theta.dtype,
                                device=a_theta.device)[None]
                a_theta = a_theta * (1.0 - eye) + eye * vmask

            group_ids = decode_group_ids(a_theta, valid)
            sg_features = group_max_pool(fused, group_ids, valid) * vmask
            if self.sg_feat_org:
                sg_features = fused
            if not self.ind_action_concat:
                res_feature = torch.cat([fused, sg_features], dim=-1)
            elif self.modality == "Multi":
                res_feature = torch.cat([rgb, lidar], dim=-1)
            else:
                res_feature = rgb if self.modality == "RGB" else lidar

            n_int = len(_INTERACTION_WIDTHS)
            pooled = masked_max(fused, valid[..., None], dim=1)    # (B, D)
            a_sum = torch.sum(a_theta, dim=(1, 2))[:, None]
            card = self.card_net_1(F.relu(self.card_net_0(
                torch.cat([pooled, a_sum], dim=-1))))
            return ModelOutputs(
                a_theta=a_theta,
                pose=self._heads("pose_head", 3, res_feature, vmask),
                interaction=self._heads("intrctn_head", n_int, res_feature,
                                        vmask),
                sg_pose=self._heads("SG_pose_head", 3, sg_features, vmask),
                sg_interaction=self._heads("SG_intrctn_head", n_int,
                                           sg_features, vmask),
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
        self.dtype = compute_dtype(cfg.model.dtype)
        self.image_mean = tuple(cfg.data.image_mean)
        self.image_std = tuple(cfg.data.image_std)
        kw = dict(device=device, generator=generator)
        # only the backbones the modality needs are built and run
        modality = cfg.model.fusion.modality
        self.rgb_backbone = RGBBackbone(cfg.model.rgb, dtype=self.dtype,
                                        **kw) \
            if modality in ("RGB", "Multi") else None
        self.lidar_backbone = LiDARBackbone(
            cfg.model.lidar, cfg.data.point_cloud, dtype=self.dtype, **kw) \
            if modality in ("LiDAR", "Multi") else None
        self.gar_fusion = GARFusionNet(cfg.model, **kw)
        self.eval()

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """A backbone's features back in float32 at bf16
        (models/mgar.py:208, :216)."""
        return x if self.dtype == torch.float32 else x.float()

    def forward(self, batch: Batch) -> ModelOutputs:
        rgb = lidar = None
        if self.rgb_backbone is not None:
            with span("mgar.rgb"):
                images = batch.images
                if images.dtype == torch.uint8:
                    # device-side ImageNet normalize of raw frames
                    mean = torch.tensor(self.image_mean, device=images.device)
                    std = torch.tensor(self.image_std, device=images.device)
                    images = images.to(torch.float32) \
                        * (1.0 / (255.0 * std)) - mean / std
                rgb = self._features(self.rgb_backbone(
                    cast(images, self.dtype), batch.boxes2d,
                    batch.person_valid))
        if self.lidar_backbone is not None:
            # batch.rulebook None: the sparse backbone builds its maps on
            # the device
            with span("mgar.lidar"):
                lidar = self._features(self.lidar_backbone(
                    batch.voxels, batch.voxel_coords, batch.voxel_num_points,
                    batch.voxel_valid, batch.boxes3d, batch.person_valid,
                    batch.rulebook))
        with span("mgar.fusion"):
            return self.gar_fusion(rgb, lidar, batch.boxes2d, batch.boxes3d,
                                   batch.person_valid)
