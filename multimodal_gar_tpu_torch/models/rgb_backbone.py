"""RGB branch (models/rgb_backbone.py:31-126): I3D to Mixed_4f with the
center-slice cull (eval) -> middle time slice -> RoIAlign 5x5 -> attention ->
832 -> 512 embedding. The attention is one of:

  - default: per-person 2D non-local block (dot), then the mean;
  - ``inter_person``: one 3D non-local block across (person, H, W);
  - ``two_stage_att``: SpaTempSelfAtt (2D within each person, then 1D
    across the people, the batch folded into the people axis);
  - ``gat_module`` (with any of the above): GATv2 over all pairs of valid
    people after the embedding.

With ``i3d_freeze`` (the default) the I3D is frozen: it runs its eval path
under ``torch.no_grad()`` in training too, and stays in eval mode when the
model is put in training mode, as ``i3d_train = train and not i3d_freeze``
and ``stop_gradient`` make it in the JAX package (rgb_backbone.py:53,81-82).
With ``i3d_freeze: false`` the I3D trains with the rest: training mode
reaches it (training BatchNorms, no cone cull, ``i3d_remat`` honoured) and
its features keep their gradient. The non-local block and the embedding
train in both cases.

``dtype`` bfloat16 (``model.dtype``): the clips arrive in bf16,
and the I3D, the RoIAlign (its boxes and interpolation weights in the
features' dtype, models/rgb_backbone.py:84 and ops/roi_align.py:77), the
attention and the embedding run at bf16, as the JAX package's RGBBackbone
does; the GATv2 layer, built without a dtype there, computes in float32."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.roi_align import roi_align
from ..utils.profiling import span
from .gat import GATv2Layer
from .i3d import ENDPOINT_CHANNELS, InceptionI3d
from .layers import KAIMING, dense, linear
from .nonlocal_block import NLBlockND
from .spa_temp import SpaTempSelfAtt


class RGBBackbone(nn.Module):

    def __init__(self, cfg, *, device, generator,
                 dtype: torch.dtype = torch.float32):
        """cfg: multimodal_gar_tpu_torch.config.RGBBackboneConfig."""
        super().__init__()
        self.dtype = dtype
        in_ch = ENDPOINT_CHANNELS[cfg.i3d_endpoint]
        kw = dict(device=device, generator=generator)
        center = cfg.i3d_center_slice and cfg.i3d_endpoint == "Mixed_4f"
        self.i3d_freeze = cfg.i3d_freeze
        self.i3d = InceptionI3d(cfg.i3d_endpoint, center_slice=center,
                                remat=cfg.i3d_remat, dtype=dtype, **kw)
        if self.i3d_freeze:
            self.i3d.requires_grad_(False)
        self.two_stage_att = cfg.two_stage_att
        self.inter_person = cfg.inter_person and not cfg.two_stage_att
        if self.two_stage_att:
            self.self_att = SpaTempSelfAtt(in_ch, in_ch // 8, dtype=dtype,
                                           **kw)
        else:
            self.self_att = NLBlockND(in_ch, in_ch // 8, dtype=dtype, **kw)
        self.embedding = linear(in_ch, cfg.embedding_dim, gain=KAIMING, **kw)
        self.gat = GATv2Layer(cfg.embedding_dim, cfg.embedding_dim,
                              num_heads=8, dropout_rate=0.5, **kw) \
            if cfg.gat_module else None

    def train(self, mode: bool = True) -> "RGBBackbone":
        super().train(mode)
        if self.i3d_freeze:
            self.i3d.eval()                              # frozen: eval BNs
        return self

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images (B, T, H, W, 3) normalised clips, boxes (B, N, 4) xyxy
        pixels, valid (B, N) (default: the nonzero boxes) -> (B, N,
        embedding_dim) per-person features."""
        if valid is None:
            valid = torch.any(boxes != 0, dim=-1)
        # the cone cull is exact only with the running statistics
        with span("rgb.i3d"), torch.set_grad_enabled(
                torch.is_grad_enabled() and not self.i3d_freeze):
            feats = self.i3d(images, center_slice=self.i3d.center_slice
                             and not self.i3d.training)  # (B, T', H', W', C)
        with span("rgb.box_head"):
            feats = feats[:, feats.shape[1] // 2]        # (B, H', W', C)
            scale = feats.shape[2] / images.shape[3]     # W_f / W
            box_feats = roi_align(feats.permute(0, 3, 1, 2), boxes,
                                  out_size=5,
                                  spatial_scale=scale)   # (B, N, C, 5, 5)
            b, n, c = box_feats.shape[:3]
            patches = box_feats.permute(0, 1, 3, 4, 2)   # (B, N, 5, 5, C)
            if self.two_stage_att:
                # batch folded into the entity axis: the cross-entity
                # attention then spans the batch (the reference's
                # batch-size-1 regime)
                x = self.self_att(patches.reshape(b * n, 5, 5, c))
                x = x.reshape(b, n, c)
            elif self.inter_person:
                # 3D non-local with the people as the third axis; its
                # training BatchNorm counts every row
                x = self.self_att(patches).mean(dim=(2, 3))
            else:
                x = self.self_att(patches.reshape(b * n, 5, 5, c),
                                  valid.reshape(b * n))
                x = x.mean(dim=(1, 2)).reshape(b, n, c)
            x = dense(self.embedding, x, self.dtype)
            if self.gat is not None:
                x = self.gat(x, valid)
            return x
