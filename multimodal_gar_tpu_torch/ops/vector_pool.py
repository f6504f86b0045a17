"""Vector pooling: a query's cubic neighbourhood split into a grid of
sub-voxels, the supports averaged per sub-voxel (ops/vector_pool.py;
pcdet pointnet2_stack vector_pool_gpu.cu), for PV-RCNN++.

The JAX function broadcasts the support features to (M, N, C) for every
query; at PV-RCNN++'s width (2048 keypoints, ~12k points) that is
gigabytes. Here only the (query, support) pairs that are inside are
gathered and summed with ``index_add_`` into (M * (g^3 + 1), 3 + C) bins
(the extra bin per query takes nothing), which gives the same means and
counts.
"""
from __future__ import annotations

from typing import Tuple

import torch


def vector_pool(support_xyz: torch.Tensor, support_features: torch.Tensor,
                support_valid: torch.Tensor, query_xyz: torch.Tensor,
                radius: float, grid_size: int = 3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query sub-voxel means, batched over the leading dimensions.

    support_xyz (..., N, 3), support_features (..., N, C), support_valid
    (..., N), query_xyz (..., M, 3) -> pooled (..., M, g^3, 3 + C): the
    mean offset from the query and the mean feature of each sub-voxel
    (zeros where empty); counts (..., M, g^3) int32 supports per cell. A
    support is inside where |support - query| < radius on every axis.
    """
    lead = query_xyz.shape[:-2]
    m = query_xyz.shape[-2]
    n, c = support_features.shape[-2:]
    g3 = grid_size ** 3
    cell = 2.0 * radius / grid_size
    sx = support_xyz.reshape(-1, n, 3)
    sf = support_features.reshape(-1, n, c)
    sv = support_valid.reshape(-1, n)
    qx = query_xyz.reshape(-1, m, 3)
    b = qx.shape[0]
    with torch.no_grad():
        inside = sv[:, None, :].expand(b, m, n)
        for a in range(3):                                      # (B, M, N)
            inside = inside & ((sx[:, None, :, a] - qx[:, :, None, a]).abs()
                               < radius)
        bi, qi, si = inside.nonzero(as_tuple=True)
    # the offsets of the pairs inside, recomputed so that they carry the
    # gradient of the coordinates (none is needed by the models)
    r = sx[bi, si] - qx[bi, qi]
    ci = torch.clamp(torch.floor((r + radius) / cell), 0,
                     grid_size - 1).long()
    flat = (ci[:, 0] * grid_size + ci[:, 1]) * grid_size + ci[:, 2]
    row = (bi * m + qi) * g3 + flat
    vals = torch.cat([r, sf[bi, si]], dim=-1)
    sums = vals.new_zeros((b * m * g3, 3 + c)).index_add_(0, row, vals)
    cnt = torch.zeros((b * m * g3,), dtype=torch.int32,
                      device=vals.device).index_add_(
        0, row, torch.ones_like(row, dtype=torch.int32))
    mean = sums / torch.clamp(cnt, min=1)[:, None].to(vals.dtype)
    return (mean.reshape(lead + (m, g3, 3 + c)),
            cnt.reshape(lead + (m, g3)))
