"""Neighbourhood primitives: ball query, three nearest neighbours with
their inverse-distance interpolation, and grouping (ops/neighbor.py;
pcdet pointnet2 ball_query_gpu.cu, interpolate_gpu.cu,
group_points_gpu.cu).

Batched over any leading dimensions: where the JAX package vmaps a
function of (N, ...) rows, these take (..., N, ...). Selections are exact
by construction: the ball query takes hits by their rank in point order (a
cumulative sum), and the nearest neighbours are three successive
first-index minima, so no order among equal values is left to a sort.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import safe_sqrt


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) squared distances, summed
    over x, y, z in that order without a (M, N, 3) temporary."""
    d = (a[..., :, None, 0] - b[..., None, :, 0]) ** 2
    d = d + (a[..., :, None, 1] - b[..., None, :, 1]) ** 2
    return d + (a[..., :, None, 2] - b[..., None, :, 2]) ** 2


def first_hits(hit: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(..., M, N) bool -> (pos (..., M, k) int64, count (..., M)): the
    first ``k`` True columns of each row in column order (their rank is a
    cumulative sum), slots past the row's hits at -1; count = min(hits,
    k)."""
    rank = torch.cumsum(hit.to(torch.int32), dim=-1)
    take = hit & (rank <= k)
    slot = torch.where(take, rank - 1, k).long()
    n = hit.shape[-1]
    cols = torch.arange(n, device=hit.device).expand(hit.shape)
    pos = torch.full(hit.shape[:-1] + (k + 1,), -1, dtype=torch.long,
                     device=hit.device)
    pos.scatter_(-1, slot, torch.where(take, cols, -1))
    return pos[..., :k], torch.clamp(rank[..., -1], max=k)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor, valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query, the first ``nsample`` supports within ``radius`` in
    point order, the free slots filled with the first hit; a ball with no
    hit is flagged ``empty`` and its indices are 0 (the CUDA kernel's
    semantics). xyz (..., N, 3), new_xyz (..., M, 3), valid (..., N) ->
    idx (..., M, nsample) int64, empty (..., M) bool."""
    hit = _sq_dist(new_xyz, xyz) < radius * radius
    if valid is not None:
        hit = hit & valid[..., None, :]
    pos, count = first_hits(hit, nsample)
    slot = torch.arange(nsample, device=xyz.device)
    idx = torch.where(slot < count[..., None], pos, pos[..., :1])
    empty = count == 0
    return torch.where(empty[..., None], 0, idx), empty


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             known_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest known points of each unknown point: (dist (..., M, 3),
    idx (..., M, 3) int64), nearest first, ties to the lower index (a
    row with fewer than 3 valid known points repeats an index in the
    slots of infinite distance, whose weight is 0).
    ``safe_sqrt`` keeps the gradient finite at distance 0 (every known
    point is also an unknown one in the FP layers)."""
    d2 = _sq_dist(unknown, known)
    if known_valid is not None:
        d2 = torch.where(known_valid[..., None, :], d2, torch.inf)
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        dists.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2 = d2.scatter(-1, i, torch.inf)
    dist = torch.cat(dists, -1)
    return safe_sqrt(dist.clamp(min=0.0)), torch.cat(idxs, -1)


def grouping_operation(features: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """features (..., N, C) at idx (..., M, S) -> (..., M, S, C); the
    gradient scatters back through the gather."""
    lead = features.shape[:-2]
    n, c = features.shape[-2:]
    f = features.reshape(-1, n, c)
    i = idx.reshape(f.shape[0], -1)
    out = torch.gather(f, 1, i[..., None].expand(-1, -1, c))
    return out.reshape(idx.shape + (c,))


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dist: torch.Tensor, eps: float = 1e-8
                      ) -> torch.Tensor:
    """Inverse-distance weighted mean of (..., N, C) features at the
    three_nn ``idx`` / ``dist`` -> (..., M, C)."""
    w = 1.0 / torch.clamp(dist * dist, min=eps)
    w = w / w.sum(-1, keepdim=True)
    return (w[..., None] * grouping_operation(features, idx)).sum(-2)
