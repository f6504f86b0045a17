"""GATv2 over the fully-connected actor graph, batched + masked
(models/gat.py): the reference's GATv2Conv(512, 512, 8 heads, dropout 0.5,
concat=False) over all pairs of valid people, as one dense (N, N) attention
with a validity mask."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masked import masked_softmax
from .layers import Dropout, linear


class GATv2Layer(nn.Module):
    """GATv2 (Brody et al. 2022): e_ij = a^T LeakyReLU(W_l h_i + W_r h_j).

    Multi-head with mean aggregation, attention dropout, no self loops (the
    reference builds its edges as pairs of distinct people). The
    (B, N, N, H, D) intermediate is 100 * 100 * 8 * 512 float32 = 164 MB at
    the full width of 100 actor slots."""

    def __init__(self, in_features: int, features: int = 512,
                 num_heads: int = 8, dropout_rate: float = 0.5,
                 negative_slope: float = 0.2, add_self_loops: bool = False,
                 *, device, generator):
        super().__init__()
        self.features, self.num_heads = features, num_heads
        self.negative_slope = negative_slope
        self.add_self_loops = add_self_loops
        kw = dict(device=device, generator=generator)
        self.W_l = linear(in_features, num_heads * features, **kw)
        self.W_r = linear(in_features, num_heads * features, bias=False, **kw)
        # glorot-uniform (H, D)
        limit = (6.0 / (num_heads + features)) ** 0.5
        self.att = nn.Parameter(((torch.rand(
            (num_heads, features), generator=generator) * 2 - 1) * limit
            ).to(device))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """x (B, N, C), valid (B, N) -> (B, N, features). A bf16 ``x``
        (the RGB embedding at model.dtype bfloat16) is promoted to float32,
        as flax's Dense layers without a dtype promote it."""
        x = x.to(torch.promote_types(x.dtype, self.W_l.weight.dtype))
        b, n, _ = x.shape
        h, d = self.num_heads, self.features
        wl = self.W_l(x).reshape(b, n, h, d)
        wr = self.W_r(x).reshape(b, n, h, d)
        # e[b, h, i, j] = a_h . leaky_relu(wl[i] + wr[j])
        z = F.leaky_relu(wl[:, :, None] + wr[:, None], self.negative_slope)
        e = torch.einsum("bijhd,hd->bhij", z, self.att)
        mask = valid[:, None, :] & valid[:, :, None]              # (B, N, N)
        if not self.add_self_loops:
            mask = mask & ~torch.eye(n, dtype=torch.bool,
                                     device=x.device)[None]
        att = self.dropout(masked_softmax(e, mask[:, None], dim=-1))
        out = torch.einsum("bhij,bjhd->bihd", att, wr).mean(dim=2)
        return out * valid[..., None].to(out.dtype)
