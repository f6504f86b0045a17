"""Social-group decoding, group-feature pooling and the ground-truth group
helpers of the losses (ops/grouping.py).

Batched over a leading dimension: a_theta (B, N, N), valid (B, N).
"""
from __future__ import annotations

import torch

from .masked import NEG_INF


def decode_group_ids(a_theta: torch.Tensor, valid: torch.Tensor,
                     threshold: float = 0.5) -> torch.Tensor:
    """Each person's group id: the first column of its row whose adjacency,
    with the diagonal forced to 1, reaches ``threshold``; padded rows and
    columns are excluded and padded people get their own index."""
    n = a_theta.shape[-1]
    eye = torch.eye(n, dtype=a_theta.dtype, device=a_theta.device)
    a = a_theta * (1.0 - eye) + eye
    linked = (a >= threshold) & valid[..., None, :] & valid[..., :, None]
    linked = linked | eye.bool()
    # torch.argmax returns the first maximal index: the first linked column
    return torch.argmax(linked.to(torch.int32), dim=-1).to(torch.int32)


def group_max_pool(features: torch.Tensor, group_ids: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Per-group max of (B, N, D) features, broadcast back to each member."""
    n = features.shape[-2]
    same = (group_ids[..., :, None] == group_ids[..., None, :]) \
        & valid[..., None, :]
    same = same | torch.eye(n, dtype=torch.bool, device=features.device)
    masked = torch.where(same[..., None], features[..., None, :, :], NEG_INF)
    return torch.amax(masked, dim=-2)


def gt_adjacency(social_group_id: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Ground-truth adjacency (B, N, N) from (B, N) group ids: 1 where
    i == j or the ids agree, among valid people only (padded rows and
    columns 0)."""
    n = social_group_id.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=social_group_id.device)
    same = (social_group_id[..., :, None] == social_group_id[..., None, :])
    pair = valid[..., :, None] & valid[..., None, :]
    return ((same | eye) & pair).to(torch.float32)


def num_groups(social_group_id: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(B,) float number of distinct group ids among the valid people: an
    id counts at its first valid holder."""
    n = social_group_id.shape[-1]
    sid = torch.where(valid, social_group_id,
                      torch.iinfo(torch.int32).min)
    same = (sid[..., None, :] == sid[..., :, None]) & valid[..., None, :]
    first = torch.argmax(same.to(torch.int32), dim=-1)
    is_first = torch.arange(n, device=sid.device) == first
    return torch.sum(is_first & valid, dim=-1).to(torch.float32)
