"""The reference's legacy grouping models (models/legacy.py:31-133), batched
and masked over the padded actors like the rest of the port:

  - GARNet: the RGB-only predecessor; adjacency from a Linear(2, 1) over
    [(GIoU + 1) / 2, |f_i - f_j|], action heads on each actor's features
    concatenated with its ground-truth group's max-pooled ones;
  - TranSG: learnable group tokens before the actors, a post-norm
    transformer encoder (flax MultiHeadDotProductAttention and LayerNorm
    layouts), adjacency the Gaussian similarity of a projected embedding;
  - ActBaseline: cosine Dv and GIoU Dg through a small MLP to the
    adjacency.

Parameters are named as in the flax modules, so convert.py loads the JAX
package's variables directly.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import (pairwise_cosine_similarity, pairwise_euclidean,
                            pairwise_giou_2d, safe_sqrt)
from ..ops.grouping import group_max_pool
from .layers import FFN, HeadMLP, MultiHeadAttention, linear

_INTERACTION_WIDTHS = (2, 4, 7, 5)


def _pair(valid: torch.Tensor) -> torch.Tensor:
    return valid[:, None, :] & valid[:, :, None]


class GARNet(nn.Module):
    """RGB-only predecessor over precomputed (B, N, feature_dim) actor
    features. Returns (d_sim (B, N, N), 3 pose heads, 4 interaction
    heads)."""

    def __init__(self, feature_dim: int = 1024, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.D_embed = linear(2, 1, **kw)
        for i in range(3):
            self.add_module(f"pose_{i}", HeadMLP(2 * feature_dim, 512, 4,
                                                 "softmax", **kw))
        for i, w in enumerate(_INTERACTION_WIDTHS):
            self.add_module(f"intr_{i}", HeadMLP(2 * feature_dim, 512, w,
                                                 "sigmoid", **kw))

    def forward(self, node_features: torch.Tensor, boxes2d: torch.Tensor,
                group_ids: torch.Tensor, valid: torch.Tensor):
        pair = _pair(valid).to(node_features.dtype)
        dg = (pairwise_giou_2d(boxes2d) + 1.0) / 2.0 * pair
        diff = node_features[:, :, None, :] - node_features[:, None, :, :]
        dv = safe_sqrt(torch.sum(diff * diff, dim=-1)) * pair
        d_sim = torch.sigmoid(self.D_embed(torch.stack([dg, dv], -1))[..., 0])
        emb = torch.cat([node_features,
                         group_max_pool(node_features, group_ids, valid)], -1)
        pose = tuple(getattr(self, f"pose_{i}")(emb) for i in range(3))
        inter = tuple(getattr(self, f"intr_{i}")(emb)
                      for i in range(len(_INTERACTION_WIDTHS)))
        return d_sim * pair, pose, inter


class TranSG(nn.Module):
    """Group-token transformer grouping head: (B, N, d_model) features and
    (B, N, 4) boxes in [0, 1] -> (B, N, N) adjacency."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_layers: int = 6, num_token: int = 2,
                 out_feature_dim: int = 256, sigma: float = 10.0, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_layers, self.num_token, self.sigma = num_layers, num_token, \
            sigma
        self.group_token = nn.Parameter(torch.randn(
            (num_token, d_model), generator=generator).to(device))
        for i in range(num_layers):
            self.add_module(f"mha_{i}", MultiHeadAttention(d_model, nhead,
                                                           **kw))
            # flax LayerNorm: eps 1e-6
            self.add_module(f"ln1_{i}", nn.LayerNorm(d_model, eps=1e-6,
                                                     device=device))
            self.add_module(f"ln2_{i}", nn.LayerNorm(d_model, eps=1e-6,
                                                     device=device))
            self.add_module(f"ffn_{i}", FFN(d_model, **kw))
        ctx = num_token * d_model + d_model + 4
        self.phi_0 = linear(ctx, d_model, **kw)
        self.phi_1 = linear(d_model, d_model, **kw)
        self.phi_2 = linear(d_model, out_feature_dim, **kw)

    def forward(self, features: torch.Tensor, boxes_norm: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        b, n, _ = features.shape
        seq = torch.cat([self.group_token.expand(b, -1, -1), features], 1)
        seq_valid = torch.cat([torch.ones((b, self.num_token),
                                          dtype=torch.bool,
                                          device=valid.device), valid], 1)
        mask = _pair(seq_valid)
        x = seq
        for i in range(self.num_layers):
            x = getattr(self, f"ln1_{i}")(
                x + getattr(self, f"mha_{i}")(x, x, mask))
            x = getattr(self, f"ln2_{i}")(x + getattr(self, f"ffn_{i}")(x))
        tok = x[:, :self.num_token].reshape(b, 1, -1).expand(b, n, -1)
        phi = torch.cat([tok, x[:, self.num_token:], boxes_norm], -1)
        phi = self.phi_2(F.relu(self.phi_1(F.relu(self.phi_0(phi)))))
        de = pairwise_euclidean(phi, zero_diagonal=True)
        return torch.exp(-de ** 2 / (2 * self.sigma ** 2)) \
            * _pair(valid).to(de.dtype)


class ActBaseline(nn.Module):
    """JRDB-Act baseline grouping head: [cosine Dv, GIoU Dg] through
    Linear layers of ``mlp_widths`` (ReLU between) to a sigmoid adjacency
    (B, N, N)."""

    def __init__(self, mlp_widths: Sequence[int] = (2, 16, 1), *, device,
                 generator):
        super().__init__()
        widths: Tuple[int, ...] = tuple(mlp_widths)
        self.n_fc = len(widths) - 1
        for i in range(self.n_fc):
            self.add_module(f"fc_{i}", linear(widths[i], widths[i + 1],
                                              device=device,
                                              generator=generator))

    def forward(self, features: torch.Tensor, boxes2d: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        pair = _pair(valid).to(features.dtype)
        x = torch.stack([pairwise_cosine_similarity(features) * pair,
                         pairwise_giou_2d(boxes2d) * pair], -1)
        for i in range(self.n_fc):
            x = getattr(self, f"fc_{i}")(x)
            if i < self.n_fc - 1:
                x = F.relu(x)
        return torch.sigmoid(x[..., 0]) * pair
