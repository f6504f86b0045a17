"""Two-stage spatial + cross-entity non-local attention (models/spa_temp.py):
a 2D non-local block within each entity's patch, pooled (mean or flatten),
then a 1D non-local block across the entities as one sequence."""
from __future__ import annotations

import torch
import torch.nn as nn

from .nonlocal_block import NLBlockND


class SpaTempSelfAtt(nn.Module):
    """x (N, H, W, C) per-entity patches -> (N, C') entity features; C' = C
    with ``pool`` 'avg', H * W * C with 'flat' (``patch_positions`` = H * W,
    the LiDAR 6 x 6 variant). Both blocks' training BatchNorms count every
    row, padded entities included, as in the JAX package. ``dtype``: both
    blocks' (NLBlockND)."""

    def __init__(self, in_channels: int, inter_channels: int,
                 pool: str = "avg", patch_positions: int = 1, *, device,
                 generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool not in ("avg", "flat"):
            raise ValueError(f"unknown pool {pool!r}")
        self.pool = pool
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.spa_block = NLBlockND(in_channels, inter_channels, **kw)
        if pool == "avg":
            ch, temp_inter = in_channels, inter_channels
        else:
            ch = patch_positions * in_channels
            temp_inter = ch // 2
        self.out_channels = ch
        self.temp_block = NLBlockND(ch, temp_inter, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.spa_block(x)
        feat = x.mean(dim=(1, 2)) if self.pool == "avg" \
            else x.reshape(x.shape[0], -1)
        return self.temp_block(feat[None])[0]        # one sequence of N
