"""Non-local self-attention block, dot mode, channels-last
(models/nonlocal_block.py:21-90)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import BatchNorm, linear


class NLBlockND(nn.Module):
    """x (N, *spatial, C) -> same shape: y = softmax-free dot attention over
    the flattened positions divided by their count, projected back to C by
    W_z and a BatchNorm (eps 1e-5, momentum 0.9, zero-initialised scale),
    plus x. In training the BatchNorm's statistics count only the rows of
    the ``valid`` (N,) entities (padded people excluded)."""

    def __init__(self, in_channels: int, inter_channels: int, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.g = linear(in_channels, inter_channels, **kw)
        self.theta = linear(in_channels, inter_channels, **kw)
        self.phi = linear(in_channels, inter_channels, **kw)
        self.W_z = linear(inter_channels, in_channels, **kw)
        self.W_z_bn = BatchNorm(in_channels, 1e-5, device=device,
                                momentum=0.9, zero_scale=True)

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        flat = x.reshape(n, -1, c)                                # (N, P, C)
        p = flat.shape[1]
        g_x = self.g(flat)
        f = self.theta(flat) @ self.phi(flat).transpose(1, 2)     # (N, P, P)
        y = (f / p) @ g_x
        mask = None if valid is None else valid[:, None]
        return (self.W_z_bn(self.W_z(y), mask) + flat).reshape(x.shape)
