"""Sparse-voxel index machinery (ops/voxel.py).

Every lookup goes through sorted linear keys and a binary search
(``torch.searchsorted``), as in the JAX package: O(M) memory per item and
no dense index grid (the flagship stage-0 grid, 41 x 2000 x 2000, would
take 656 MB of int32 per batch item). Keys are int32 (the flagship grid has
1.64e8 cells); invalid and out-of-range coordinates map to ``INVALID_KEY``,
which sorts last and never hits.

Coordinates follow the spconv convention: (z, y, x) int32 voxel coords.
Batched over a leading dimension where the JAX package vmaps per item.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

INVALID_KEY = torch.iinfo(torch.int32).max


class VoxelLookup(NamedTuple):
    """Sorted-key lookup table over each item's active voxels."""
    sorted_keys: torch.Tensor  # (B, M) int32, invalid rows last
    perm: torch.Tensor         # (B, M) int64: sorted position -> row


def linear_keys(coords: torch.Tensor, valid: torch.Tensor,
                spatial_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(..., 3) zyx coords -> (...) int32 keys; invalid or out-of-range
    coords -> INVALID_KEY."""
    zdim, ydim, xdim = spatial_shape
    z, y, x = coords.long().unbind(-1)
    in_range = ((z >= 0) & (z < zdim) & (y >= 0) & (y < ydim)
                & (x >= 0) & (x < xdim) & valid)
    key = (z * ydim + y) * xdim + x
    return torch.where(in_range, key, INVALID_KEY).to(torch.int32)


def build_lookup(coords: torch.Tensor, valid: torch.Tensor,
                 spatial_shape: Tuple[int, int, int]) -> VoxelLookup:
    """The lookup table of (B, M, 3) coords with (B, M) masks."""
    keys, perm = torch.sort(linear_keys(coords, valid, spatial_shape), dim=-1)
    return VoxelLookup(sorted_keys=keys.contiguous(), perm=perm)


def lookup(table: VoxelLookup, query_coords: torch.Tensor,
           query_valid: torch.Tensor,
           spatial_shape: Tuple[int, int, int]) -> torch.Tensor:
    """The voxel row holding each query coord, -1 where absent.

    query_coords (B, ..., 3) zyx, query_valid (B, ...) -> (B, ...) int32
    rows of the (unsorted) voxel arrays the table was built from."""
    b, m = table.sorted_keys.shape
    qkeys = linear_keys(query_coords, query_valid,
                        spatial_shape).reshape(b, -1)
    if m == 0:
        return torch.full(query_valid.shape, -1, dtype=torch.int32,
                          device=qkeys.device)
    pos = torch.searchsorted(table.sorted_keys, qkeys).clamp_(max=m - 1)
    hit = (torch.gather(table.sorted_keys, 1, pos) == qkeys) \
        & (qkeys != INVALID_KEY)
    idx = torch.where(hit, torch.gather(table.perm, 1, pos), -1)
    return idx.to(torch.int32).reshape(query_valid.shape)


def kernel_offsets(kernel_size: int = 3, device=None) -> torch.Tensor:
    """(K^3, 3) zyx offsets in scan order (z outer, x inner), centred."""
    r = kernel_size // 2
    g = torch.arange(-r, kernel_size - r, device=device)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)],
                       dim=-1).to(torch.int32)


def get_voxel_centers(coords_zyx: torch.Tensor, downsample_times: int,
                      voxel_size: Sequence[float],
                      point_cloud_range: Sequence[float]) -> torch.Tensor:
    """Voxel centers in metric xyz of (..., 3) zyx coords, in the default
    dtype (float32, or float64 in a float64 reference run)."""
    dev = coords_zyx.device
    vs = torch.tensor(voxel_size, device=dev) * downsample_times
    pc_min = torch.tensor(point_cloud_range[:3], device=dev)
    xyz = coords_zyx.flip(-1).to(vs.dtype)
    return (xyz + 0.5) * vs + pc_min


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) rows at idx (B, ...) -> (B, ..., x.shape[2:])."""
    bidx = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (idx.ndim - 1))
    return x[bidx, idx]


def voxel_query_boxed(voxel_centers: torch.Tensor, voxel_coords: torch.Tensor,
                      voxel_valid: torch.Tensor, query_xyz: torch.Tensor,
                      query_coords: torch.Tensor, query_valid: torch.Tensor,
                      ranges: Tuple[int, int, int], radius: float,
                      nsample: int, cull_k: int):
    """Box-grouped voxel query with a per-box spatial cull.

    The first ``nsample`` in-window, in-radius neighbours of each query in
    the reference voxel_query kernel's z/y/x scan order, searched among the
    ``cull_k`` voxels nearest each box's centroid. Selection is exact
    (``torch.topk``) where the JAX package may call ``approx_max_k``.

    Args:
      voxel_centers / voxel_coords / voxel_valid: (B, M, 3) xyz, (B, M, 3)
        zyx, (B, M) of one scale.
      query_xyz / query_coords: (B, N, G3, 3) metric xyz / zyx voxel coords.
      query_valid: (B, N, G3).
    Returns:
      cand: (B, N, K) culled voxel rows per box;
      local: (B, N * G3, nsample) positions into ``cand`` (0 where empty);
      empty: (B, N * G3) bool.
    """
    b, n, g3 = query_xyz.shape[:3]
    m = voxel_centers.shape[1]
    k = min(cull_k, m)
    rz, ry, rx = ranges
    wz, wy, wx = 2 * rz + 1, 2 * ry + 1, 2 * rx + 1
    wsize = wz * wy * wx
    r2 = radius * radius

    # cull: the k voxels nearest each box centroid
    box_centers = torch.mean(query_xyz, dim=2)                   # (B, N, 3)
    bn = torch.sum(box_centers * box_centers, dim=-1)
    vn = torch.sum(voxel_centers * voxel_centers, dim=-1)
    d2b = bn[..., None] + vn[:, None, :] \
        - 2.0 * box_centers @ voxel_centers.transpose(1, 2)      # (B, N, M)
    d2b = torch.where(voxel_valid[:, None, :], d2b, float("inf"))
    cand = torch.topk(d2b, k, dim=-1, largest=False).indices     # (B, N, K)
    cand_centers = _take(voxel_centers, cand)                    # (B,N,K,3)
    cand_coords = _take(voxel_coords, cand)
    cand_valid = _take(voxel_valid, cand)

    # per-box window relation
    delta = cand_coords[:, :, None] - query_coords[:, :, :, None]  # B,N,G3,K,3
    dz, dy, dx = delta.unbind(-1)
    in_win = (torch.abs(dz) <= rz) & (torch.abs(dy) <= ry) \
        & (torch.abs(dx) <= rx)
    qn = torch.sum(query_xyz * query_xyz, dim=-1)                # (B, N, G3)
    cn = torch.sum(cand_centers * cand_centers, dim=-1)          # (B, N, K)
    d2 = qn[..., None] + cn[:, :, None, :] \
        - 2.0 * torch.einsum("bngc,bnkc->bngk", query_xyz, cand_centers)
    hit = in_win & (d2 < r2) & cand_valid[:, :, None, :] \
        & query_valid[..., None]
    priority = ((dz + rz) * wy + (dy + ry)) * wx + (dx + rx)
    priority = torch.where(hit, priority, wsize)                 # (B,N,G3,K)
    local, empty = _first_hits(priority.reshape(b, n * g3, -1), None,
                               nsample, wsize)
    return cand, local, empty


def _first_hits(priority: torch.Tensor, rows: torch.Tensor, nsample: int,
                wsize: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``nsample`` hits of least window priority (``wsize`` = no hit)
    along the last axis, by exact top-k: (rows of them, repeating the first
    hit in unfilled slots and 0 where the query has none; empty flags).
    ``rows`` maps a position on the last axis to the row reported, or is
    None for the position itself."""
    if priority.shape[-1] < nsample:
        priority = torch.nn.functional.pad(
            priority, (0, nsample - priority.shape[-1]), value=wsize)
    vals, pos = torch.topk(priority, nsample, dim=-1, largest=False,
                           sorted=True)
    chosen_valid = vals < wsize
    chosen = pos if rows is None else torch.gather(rows, -1, pos)
    idx = torch.where(chosen_valid, chosen, chosen[..., :1])
    empty = ~chosen_valid[..., 0]
    return torch.where(empty[..., None], 0, idx), empty


def voxel_query(voxel_centers: torch.Tensor, voxel_coords: torch.Tensor,
                voxel_valid: torch.Tensor, query_xyz: torch.Tensor,
                query_coords: torch.Tensor, query_valid: torch.Tensor,
                ranges: Tuple[int, int, int], radius: float, nsample: int,
                query_chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``nsample`` in-window, in-radius neighbour voxels of each
    query in the reference kernel's z/y/x window scan order, from the dense
    query x voxel relation: squared distances in the expanded form
    ``|q|^2 + |v|^2 - 2 q.v`` (one matmul), window membership from
    coordinate deltas, selection by exact top-k over the window position.
    Queries go in chunks of ``query_chunk`` to bound the (chunk, M)
    intermediates (each chunk holds several (chunk, M) int32 tensors).

    voxel_centers / voxel_coords / voxel_valid: (B, M, 3) xyz, (B, M, 3)
    zyx, (B, M); query_xyz / query_coords: (B, R, 3); query_valid (B, R).
    Returns idx (B, R, nsample) voxel rows (0 where empty), empty (B, R).
    """
    rz, ry, rx = ranges
    wy, wx = 2 * ry + 1, 2 * rx + 1
    wsize = (2 * rz + 1) * wy * wx
    r2 = radius * radius
    vn = torch.sum(voxel_centers * voxel_centers, dim=-1)          # (B, M)
    vz, vy, vx = voxel_coords.unbind(-1)
    idx, empty = [], []
    for lo in range(0, query_xyz.shape[1], query_chunk):
        q_xyz = query_xyz[:, lo:lo + query_chunk]
        qz, qy, qx = query_coords[:, lo:lo + query_chunk].unbind(-1)
        q_valid = query_valid[:, lo:lo + query_chunk]
        dz = vz[:, None, :] - qz[..., None]                        # (B, C, M)
        dy = vy[:, None, :] - qy[..., None]
        dx = vx[:, None, :] - qx[..., None]
        in_win = (dz.abs() <= rz) & (dy.abs() <= ry) & (dx.abs() <= rx)
        qn = torch.sum(q_xyz * q_xyz, dim=-1)
        d2 = qn[..., None] + vn[:, None, :] \
            - 2.0 * q_xyz @ voxel_centers.transpose(1, 2)
        hit = in_win & (d2 < r2) & voxel_valid[:, None, :] \
            & q_valid[..., None]
        del in_win, d2
        priority = ((dz + rz) * wy + (dy + ry)) * wx + (dx + rx)
        del dz, dy, dx
        i, e = _first_hits(torch.where(hit, priority, wsize), None, nsample,
                           wsize)
        idx.append(i)
        empty.append(e)
    return torch.cat(idx, dim=1), torch.cat(empty, dim=1)
