"""VoxelBackbone8x's index maps built on the device, without a host
rulebook (models/sparse_backbone.py: _neighbor_idx_subm,
_downsample_active_set and SparseConv3dDown's gather map).

``device_rulebook`` returns the dict that the host rulebook's nbr-map half
holds (data/rulebook.py: build_rulebook) and equal to it entry for entry:

  nbr_k     (B, M_k, 27) int32   submanifold 3^3 neighbour rows (-1 absent)
  down_k    (B, M_k, 27) int32   rows of stage k-1 feeding each output row
                                 (k >= 1; -1 absent)
  coords_k  (B, M_k, 3) int32    stage k's active set in linear-key order,
                                 -1 on padded rows (k >= 1)
  count_k   (B,) int32           stage k's active sites (k >= 1)

and ``dropped_k`` (B,) int32, the output sites a stage's cap cut off
(``dropped_sites`` of the JAX package). A stage whose unique output sites
exceed its cap keeps the smallest keys, as ``jnp.unique(size=)`` does.
Stage 0 keeps the rows and order of its input; the rows that count are
those ``valid`` marks.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .voxel import (INVALID_KEY, build_lookup, kernel_offsets, linear_keys,
                    lookup)

# the host rulebook's stage constants (data/rulebook.py): stage k
# downsamples by STAGE_STRIDES[k] with padding STAGE_PADDINGS[k]
STAGE_STRIDES = (1, 2, 2, 2)
STAGE_PADDINGS = ((1, 1, 1), (1, 1, 1), (1, 1, 1), (0, 1, 1))

Shape = Tuple[int, int, int]


def _tup3(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _corner_offsets(device, kernel_size=3) -> torch.Tensor:
    """(kz * ky * kx, 3) zyx tap offsets from 0 of a strided conv, scan
    order (z outer, x inner): ``_kernel_offsets_aniso``."""
    zz, yy, xx = torch.meshgrid(
        *(torch.arange(k, device=device) for k in _tup3(kernel_size)),
        indexing="ij")
    return torch.stack([zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)],
                       dim=-1).to(torch.int32)


def conv_out_shape(shape: Shape, kernel_size, stride, padding) -> Shape:
    """Spatial shape of a strided conv's output (``_downsample_shape``)."""
    return tuple((d + 2 * p - k) // s + 1 for d, k, s, p in zip(
        shape, _tup3(kernel_size), _tup3(stride), _tup3(padding)))


def neighbor_map(coords: torch.Tensor, valid: torch.Tensor,
                 spatial_shape: Shape) -> torch.Tensor:
    """(B, M, 27) row of each voxel's 3^3 neighbour in scan order, -1 where
    absent (``_neighbor_idx_subm``)."""
    table = build_lookup(coords, valid, spatial_shape)
    nbr = coords[:, :, None, :] + kernel_offsets(3, coords.device)
    return lookup(table, nbr, valid[..., None].expand(nbr.shape[:-1]),
                  spatial_shape)


def downsample_active_set(coords: torch.Tensor, valid: torch.Tensor,
                          out_shape: Shape, stride, padding, max_out: int,
                          kernel_size=3):
    """The strided conv's output active set (``_downsample_active_set``):
    output site o is active iff some active input i = o * stride - pad + k
    exists, for a (kz, ky, kx) kernel (an int: cubic) and a per-axis stride
    and padding (an int: the same on every axis). Returns coords (B,
    max_out, 3), -1 on padded rows; valid (B, max_out); count (B,) int32;
    dropped (B,) int32, the unique sites beyond ``max_out`` (the smallest
    keys are kept)."""
    b = coords.shape[0]
    dev = coords.device
    pad = torch.tensor(_tup3(padding), dtype=torch.int32, device=dev)
    st = torch.tensor(_tup3(stride), dtype=torch.int32, device=dev)
    num = coords[:, :, None, :] + pad \
        - _corner_offsets(dev, kernel_size)                        # B,M,K,3
    o = torch.div(num, st, rounding_mode="floor")
    exact = torch.all(o * st == num, dim=-1)
    keys = linear_keys(o.reshape(b, -1, 3),
                       (valid[..., None] & exact).reshape(b, -1), out_shape)
    sk = torch.sort(keys, dim=-1).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    keep = first & (sk != INVALID_KEY)
    n_unique = keep.sum(dim=-1)
    rank = torch.cumsum(keep, dim=-1) - 1
    # every key past the cap (and every duplicate) lands on a spare column
    target = torch.where(keep & (rank < max_out), rank, max_out)
    out = torch.full((b, max_out + 1), INVALID_KEY, dtype=torch.int32,
                     device=dev)
    out.scatter_(1, target, sk)
    out_keys = out[:, :max_out].long()
    out_valid = out_keys != INVALID_KEY
    _, ydim, xdim = out_shape
    zyx = torch.stack([out_keys // (ydim * xdim), (out_keys // xdim) % ydim,
                       out_keys % xdim], dim=-1)
    out_coords = torch.where(out_valid[..., None], zyx, -1).to(torch.int32)
    count = torch.clamp(n_unique, max=max_out).to(torch.int32)
    dropped = torch.clamp(n_unique - max_out, min=0).to(torch.int32)
    return out_coords, out_valid, count, dropped


def down_map(in_coords: torch.Tensor, in_valid: torch.Tensor,
             in_shape: Shape, out_coords: torch.Tensor,
             out_valid: torch.Tensor, stride, padding,
             kernel_size=3) -> torch.Tensor:
    """(B, Mo, K) input row feeding each output row at each of the K taps
    of the strided conv (i = o * stride - pad + k), -1 where absent."""
    table = build_lookup(in_coords, in_valid, in_shape)
    dev = in_coords.device
    pad = torch.tensor(_tup3(padding), dtype=torch.int32, device=dev)
    st = torch.tensor(_tup3(stride), dtype=torch.int32, device=dev)
    src = out_coords[:, :, None, :] * st - pad \
        + _corner_offsets(dev, kernel_size)                       # B,Mo,K,3
    return lookup(table, src, out_valid[..., None].expand(src.shape[:-1]),
                  in_shape)


def stage_shape(shape: Shape, k: int) -> Shape:
    """Spatial shape of stage k's output from stage k-1's."""
    return tuple((d + 2 * p - 3) // STAGE_STRIDES[k] + 1
                 for d, p in zip(shape, STAGE_PADDINGS[k]))


def device_rulebook(coords: torch.Tensor, valid: torch.Tensor,
                    spatial_shape: Shape,
                    max_voxels_per_stage: Sequence[int],
                    paddings: Sequence = STAGE_PADDINGS
                    ) -> Dict[str, torch.Tensor]:
    """The nbr / down maps of a stack of 3^3 stages from stage 0's
    (B, M0, 3) zyx coords and (B, M0) mask, on their device: as many
    stages as ``max_voxels_per_stage`` has caps, stage k >= 1 a stride-2
    conv padded by ``paddings[k]`` (VoxelBackbone8x's four stages by
    default; the residual and VoxelNeXt backbones have more)."""
    out: Dict[str, torch.Tensor] = {}
    cur_c, cur_v, cur_shape = coords, valid, tuple(spatial_shape)
    for k in range(len(max_voxels_per_stage)):
        if k > 0:
            shape = conv_out_shape(cur_shape, 3, 2, paddings[k])
            oc, ov, count, dropped = downsample_active_set(
                cur_c, cur_v, shape, 2, paddings[k],
                max_voxels_per_stage[k])
            out[f"down_{k}"] = down_map(cur_c, cur_v, cur_shape, oc, ov, 2,
                                        paddings[k])
            out[f"coords_{k}"], out[f"count_{k}"] = oc, count
            out[f"dropped_{k}"] = dropped
            cur_c, cur_v, cur_shape = oc, ov, shape
        out[f"nbr_{k}"] = neighbor_map(cur_c, cur_v, cur_shape)
    return out
