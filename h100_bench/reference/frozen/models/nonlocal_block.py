"""Non-local self-attention block, dot mode, channels-last
(models/nonlocal_block.py:21-90), in float32 or, with ``dtype`` bfloat16,
as flax runs it at bf16: every Dense, product and the BatchNorm's result
in bf16; the residual adds the input in the promoted dtype (float32 where
the input is float32, as the LiDAR branch's grid features are)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import BatchNorm, dense, linear, scalar


class NLBlockND(nn.Module):
    """x (N, *spatial, C) -> same shape: y = softmax-free dot attention over
    the flattened positions divided by their count, projected back to C by
    W_z and a BatchNorm (eps 1e-5, momentum 0.9, zero-initialised scale),
    plus x. In training the BatchNorm's statistics count only the rows of
    the ``valid`` (N,) entities (padded people excluded)."""

    def __init__(self, in_channels: int, inter_channels: int, *, device,
                 generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.g = linear(in_channels, inter_channels, **kw)
        self.theta = linear(in_channels, inter_channels, **kw)
        self.phi = linear(in_channels, inter_channels, **kw)
        self.W_z = linear(inter_channels, in_channels, **kw)
        self.W_z_bn = BatchNorm(in_channels, 1e-5, device=device,
                                momentum=0.9, zero_scale=True, dtype=dtype)

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        flat = x.reshape(n, -1, c)                                # (N, P, C)
        p = flat.shape[1]
        dt = self.dtype
        g_x = dense(self.g, flat, dt)
        f = dense(self.theta, flat, dt) @ dense(self.phi, flat,
                                                dt).transpose(1, 2)
        y = (f / scalar(p, dt)) @ g_x                             # (N, P, Ci)
        mask = None if valid is None else valid[:, None]
        w_y = self.W_z_bn(dense(self.W_z, y, dt), mask)
        return (w_y + flat).reshape(x.shape)
