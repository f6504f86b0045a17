"""Sparse 3D conv backbone VoxelBackbone8x (models/sparse_backbone.py:
111-447), as the reference runs it: with no rulebook, its nbr and down maps
built on the features' device (ops/device_rulebook.py, the JAX package's
on-device neighbour search) and every conv, the 8 submanifold and the 3
strided ones, an index-map conv (ops/kernels/subm_conv.py) over ``nbr_k``
/ ``down_k`` in the original row order; ``dropped_sites`` holds each
strided stage's sites cut off by its cap. In training the convs
differentiate over the explicit maps of ops/sparse_maps.py. Weight layout:
(27, Cin, Cout) in (dz, dy, dx) scan order.

Active voxels live in padded (B, M, C) arrays with (B, M, 3) zyx coords and
(B, M) masks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.subm_conv import subm_conv
from ..ops.device_rulebook import device_rulebook, stage_shape
from ..ops.sparse_maps import ConvMaps, backbone_maps
from .layers import KAIMING, BatchNorm, draw


@dataclasses.dataclass
class SparseTensor:
    """Padded batch of sparse voxel sets."""
    features: torch.Tensor                 # (B, M, C)
    coords: torch.Tensor                   # (B, M, 3) int32 zyx
    valid: torch.Tensor                    # (B, M) bool
    spatial_shape: Tuple[int, int, int]


class SparseConv(nn.Module):
    """3x3x3 sparse conv over ``maps.fwd``: submanifold for an ``nbr_k``
    map (output rows = input rows), strided for a ``down_k`` map (output
    rows of the next stage)."""

    def __init__(self, cin: int, cout: int, *, device, generator):
        super().__init__()
        self.weight = nn.Parameter(draw((27, cin, cout),
                                        (KAIMING / (27 * cin)) ** 0.5,
                                        device=device, generator=generator))

    def forward(self, features: torch.Tensor, maps: ConvMaps,
                out_valid: torch.Tensor) -> torch.Tensor:
        out = subm_conv(features, maps.fwd, self.weight, maps)
        return out * out_valid[..., None].to(out.dtype)


class SparseConvBlock(nn.Module):
    """conv + BatchNorm(eps=1e-3, momentum=0.99, masked by the valid rows)
    + ReLU, zero on padded rows."""

    def __init__(self, cin: int, cout: int, *, device, generator):
        super().__init__()
        self.conv = SparseConv(cin, cout, device=device, generator=generator)
        self.bn = BatchNorm(cout, 1e-3, device=device, momentum=0.99)

    def forward(self, features, maps, out_valid):
        f = self.bn(self.conv(features, maps, out_valid), out_valid)
        return F.relu(f) * out_valid[..., None].to(f.dtype)


# (name, cin (None: the voxel features), cout, stage, strided), in order
_LAYERS = (
    ("conv_input", None, 16, 0, False),
    ("conv1_0", 16, 16, 0, False),
    ("conv2_down", 16, 32, 1, True),
    ("conv2_1", 32, 32, 1, False),
    ("conv2_2", 32, 32, 1, False),
    ("conv3_down", 32, 64, 2, True),
    ("conv3_1", 64, 64, 2, False),
    ("conv3_2", 64, 64, 2, False),
    ("conv4_down", 64, 64, 3, True),
    ("conv4_1", 64, 64, 3, False),
    ("conv4_2", 64, 64, 3, False),
)
_STAGE_OUTPUT = {"conv1_0": "x_conv1", "conv2_2": "x_conv2",
                 "conv3_2": "x_conv3", "conv4_2": "x_conv4"}


class VoxelBackbone8x(nn.Module):
    """4-stage sparse stem: 16 -> 32 -> 64 -> 64 channels at strides
    1/2/4/8. Returns {x_conv1..x_conv4} SparseTensors.
    ``max_voxels_per_stage`` caps the stages of the maps. ``x_window`` and
    ``dtype`` are the port's arguments: the reference runs the index-map
    path at float32 whatever they say."""

    def __init__(self, in_channels: int, *, device, generator,
                 x_window: bool = True,
                 max_voxels_per_stage=(16000, 16000, 8000, 4000),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise ValueError("the reference runs at float32")
        self.max_voxels_per_stage = tuple(max_voxels_per_stage)
        # (B,) int32 per strided stage k: sites its cap cut off in the last
        # forward
        self.dropped_sites: Dict[int, torch.Tensor] = {}
        for name, cin, cout, _, _ in _LAYERS:
            self.add_module(name, SparseConvBlock(
                in_channels if cin is None else cin, cout, device=device,
                generator=generator))

    def forward(self, st: SparseTensor, rulebook=None):
        """{x_conv1..x_conv4}; a ``rulebook`` is the program's and is left
        out: the maps are built here."""
        rb = device_rulebook(st.coords, st.valid, st.spatial_shape,
                             self.max_voxels_per_stage)
        self.dropped_sites = {k: rb[f"dropped_{k}"] for k in (1, 2, 3)}
        f, coords, valid = st.features, st.coords, st.valid
        maps = backbone_maps(rb, key_sorted=False,
                             with_bwd=torch.is_grad_enabled())
        shape = st.spatial_shape
        out = {}
        for name, _, _, k, strided in _LAYERS:
            if strided:
                count = rb[f"count_{k}"]
                coords = rb[f"coords_{k}"]
                valid = (torch.arange(coords.shape[1], device=count.device)
                         [None, :] < count[:, None])
                shape = stage_shape(shape, k)
            map_key = f"down_{k}" if strided else f"nbr_{k}"
            f = getattr(self, name)(f, maps[map_key], valid)
            if name in _STAGE_OUTPUT:
                out[_STAGE_OUTPUT[name]] = SparseTensor(f, coords, valid,
                                                        shape)
        return out


BACKBONE_STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
BACKBONE_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64,
                     "x_conv4": 64}
