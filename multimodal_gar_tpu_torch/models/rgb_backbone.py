"""RGB branch, default path (models/rgb_backbone.py:31-126): frozen I3D to
Mixed_4f with the center-slice cull -> middle time slice -> RoIAlign 5x5 ->
per-person 2D non-local block -> mean -> 832 -> 512 embedding.

The I3D is frozen (``i3d_freeze``): it runs its eval path under
``torch.no_grad()`` in training too, and stays in eval mode when the model
is put in training mode, as ``i3d_train = train and not i3d_freeze`` and
``stop_gradient`` make it in the JAX package (rgb_backbone.py:53,81-82).
The non-local block and the embedding train."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.roi_align import roi_align
from .i3d import ENDPOINT_CHANNELS, InceptionI3d
from .layers import KAIMING, linear
from .nonlocal_block import NLBlockND


class RGBBackbone(nn.Module):

    def __init__(self, cfg, *, device, generator):
        """cfg: multimodal_gar_tpu_torch.config.RGBBackboneConfig."""
        super().__init__()
        if cfg.inter_person or cfg.two_stage_att or cfg.gat_module:
            raise NotImplementedError(
                "only the default per-person 2D non-local RGB path is ported")
        if not cfg.i3d_freeze:
            raise NotImplementedError("only the frozen I3D is ported")
        in_ch = ENDPOINT_CHANNELS[cfg.i3d_endpoint]
        kw = dict(device=device, generator=generator)
        center = cfg.i3d_center_slice and cfg.i3d_endpoint == "Mixed_4f"
        self.i3d = InceptionI3d(cfg.i3d_endpoint, center_slice=center, **kw)
        self.i3d.requires_grad_(False)
        self.self_att = NLBlockND(in_ch, in_ch // 8, **kw)
        self.embedding = linear(in_ch, cfg.embedding_dim, gain=KAIMING, **kw)

    def train(self, mode: bool = True) -> "RGBBackbone":
        super().train(mode)
        self.i3d.eval()                                  # frozen: eval BNs
        return self

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images (B, T, H, W, 3) normalised clips, boxes (B, N, 4) xyxy
        pixels, valid (B, N) (default: the nonzero boxes) -> (B, N,
        embedding_dim) per-person features."""
        if valid is None:
            valid = torch.any(boxes != 0, dim=-1)
        with torch.no_grad():
            feats = self.i3d(images)                     # (B, T', H', W', C)
        feats = feats[:, feats.shape[1] // 2]            # (B, H', W', C)
        scale = feats.shape[2] / images.shape[3]         # W_f / W
        box_feats = roi_align(feats.permute(0, 3, 1, 2), boxes, out_size=5,
                              spatial_scale=scale)       # (B, N, C, 5, 5)
        b, n, c = box_feats.shape[:3]
        patches = box_feats.permute(0, 1, 3, 4, 2).reshape(b * n, 5, 5, c)
        x = self.self_att(patches, valid.reshape(b * n))
        x = x.mean(dim=(1, 2)).reshape(b, n, c)
        return self.embedding(x)
