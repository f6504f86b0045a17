"""Point sampling: farthest point sampling and its gather
(ops/sampling.py; pcdet pointnet2 sampling_gpu.cu).

FPS is sequential in the sampled points: one loop over ``npoint`` whose
every step updates all point sets at once (the batch, and for PointRCNN's
per-RoI encoder every RoI), with no host read inside the loop.
"""
from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e10


def farthest_point_sampling(xyz: torch.Tensor, npoint: int,
                            valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(..., N, 3) points -> (..., npoint) int64 indices by iterative
    farthest-point sampling, each set on its own.

    The first index is the set's first valid point (0 where none is);
    invalid points are never selected while a valid one is left unchosen:
    their candidate distance is pinned at -1e10. Ties take the lowest
    index, as ``jnp.argmax`` does.
    """
    lead = xyz.shape[:-2]
    n = xyz.shape[-2]
    pts = xyz.reshape(-1, n, 3)
    g = pts.shape[0]
    if valid is None:
        ok = torch.ones((g, n), dtype=torch.bool, device=xyz.device)
    else:
        ok = valid.reshape(g, n)
    neg = torch.tensor(-_BIG, dtype=xyz.dtype, device=xyz.device)
    dists = torch.full((g, n), _BIG, dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros((g, npoint), dtype=torch.long, device=xyz.device)
    last = torch.argmax(ok.to(torch.uint8), dim=1)
    idxs[:, 0] = last
    rows = torch.arange(g, device=xyz.device)
    for i in range(1, npoint):
        d = ((pts - pts[rows, last][:, None, :]) ** 2).sum(-1)
        dists = torch.minimum(dists, d)
        last = torch.argmax(torch.where(ok, dists, neg), dim=1)
        idxs[:, i] = last
    return idxs.reshape(lead + (npoint,))


def stacked_farthest_point_sampling(xyz: torch.Tensor, valid: torch.Tensor,
                                    npoint: int) -> torch.Tensor:
    """Batched FPS over (B, N, 3) with per-item masks -> (B, npoint)."""
    return farthest_point_sampling(xyz, npoint, valid)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (..., N, C) at idx (..., K) -> (..., K, C); the leading
    dimensions are the sets'."""
    lead = features.shape[:-2]
    n, c = features.shape[-2:]
    f = features.reshape(-1, n, c)
    i = idx.reshape(f.shape[0], -1)
    out = torch.gather(f, 1, i[..., None].expand(-1, -1, c))
    return out.reshape(lead + idx.shape[len(lead):] + (c,))
