"""Sparse 3D conv backbone VoxelBackbone8x over the host rulebook
(models/sparse_backbone.py:111-447).

Active voxels live in padded (B, M, C) arrays with (B, M, 3) zyx coords and
(B, M) masks. The rulebook (data/rulebook.py) selects the path as the JAX
package does (``x_window and "win_0" in rb``, sparse_backbone.py:369):

- x-window path: every conv, the 8 submanifold and the 3 strided ones, runs
  through the fused x-window kernel (ops/kernels/window_conv.py) over the
  packed maps, ``win_k`` for the submanifold layers and ``dwin_k`` into
  stage k-1's rows for the strided ones, with stage 0 reordered by key;
- nbr-map path: every conv runs through the index-map kernel K3
  (ops/kernels/subm_conv.py) over ``nbr_k`` / ``down_k`` in the original
  row order.

Without a rulebook (or one that carries neither map family) the nbr and
down maps are built on the features' device (ops/device_rulebook.py, the
JAX package's on-device neighbour search) and the nbr-map path runs over
them; ``dropped_sites`` then holds each strided stage's sites cut off by
its cap.

In training both paths differentiate through the sparse convs' backward
kernels over the explicit maps of ops/sparse_maps.py. Weight layout:
(27, Cin, Cout) in (dz, dy, dx) scan order.

``dtype`` bfloat16 (``model.dtype``) follows the JAX package's cast
points: each sparse conv rounds its input table and its weights to bf16
(models/sparse_backbone.py:172, :298) and runs the kernel's bf16 variant,
whose output is bf16; the BatchNorm after it, built without a dtype in
flax, returns float32, so the ReLU and the next layer's input are float32
(sparse_backbone.py:340-345). In training the table's cast lies inside the
sparse conv's autograd function (ops/kernels/subm_conv.py:
SparseConvFunction), which returns the float32 d(features) of XLA's VJP
(kernel C) and a bf16 d(weights) (kernel D) that the weights' cast widens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.subm_conv import subm_conv
from ..ops.kernels.window_conv import window_conv
from ..ops.device_rulebook import (conv_out_shape, device_rulebook,
                                   down_map, downsample_active_set,
                                   stage_shape)
from ..ops.sparse_maps import ConvMaps, backbone_maps, gather_taps
from .layers import KAIMING, BatchNorm, cast, draw


@dataclasses.dataclass
class SparseTensor:
    """Padded batch of sparse voxel sets."""
    features: torch.Tensor                 # (B, M, C)
    coords: torch.Tensor                   # (B, M, 3) int32 zyx
    valid: torch.Tensor                    # (B, M) bool
    spatial_shape: Tuple[int, int, int]


class SparseConv(nn.Module):
    """3x3x3 sparse conv: through the x-window kernel over ``win`` where it
    is given, else through K3 over ``maps.fwd``. Submanifold for a
    ``win_k`` / ``nbr_k`` map (output rows = input rows), strided for a
    ``dwin_k`` / ``down_k`` map (output rows of the next stage). At
    ``dtype`` bfloat16 the weights are rounded to bf16 here and the table
    inside the conv (ops/kernels/subm_conv.py: sparse_conv), and the
    output is bf16."""

    def __init__(self, cin: int, cout: int, *, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(draw((27, cin, cout),
                                        (KAIMING / (27 * cin)) ** 0.5,
                                        device=device, generator=generator))

    def forward(self, features: torch.Tensor, win: Optional[torch.Tensor],
                maps: Optional[ConvMaps], out_valid: torch.Tensor
                ) -> torch.Tensor:
        weight = cast(self.weight, self.dtype)
        if win is not None:
            out = window_conv(features, win, weight, maps)
        else:
            out = subm_conv(features, maps.fwd, weight, maps)
        return out * out_valid[..., None].to(out.dtype)


class SparseConvBlock(nn.Module):
    """conv + BatchNorm(eps=1e-3, momentum=0.99, masked by the valid rows)
    + ReLU, zero on padded rows; float32 out at either ``dtype``."""

    def __init__(self, cin: int, cout: int, *, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SparseConv(cin, cout, device=device, generator=generator,
                               dtype=dtype)
        self.bn = BatchNorm(cout, 1e-3, device=device, momentum=0.99)

    def forward(self, features, win, maps, out_valid):
        f = self.bn(self.conv(features, win, maps, out_valid), out_valid)
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
    1/2/4/8. Returns {x_conv1..x_conv4} SparseTensors. ``x_window`` selects
    the x-window path where the rulebook carries its maps;
    ``max_voxels_per_stage`` caps the stages of maps built on the device;
    ``dtype`` is the sparse convs' compute dtype."""

    def __init__(self, in_channels: int, *, device, generator,
                 x_window: bool = True,
                 max_voxels_per_stage=(16000, 16000, 8000, 4000),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.x_window = x_window
        self.max_voxels_per_stage = tuple(max_voxels_per_stage)
        # (B,) int32 per strided stage k: sites its cap cut off in the last
        # forward that built its maps on the device
        self.dropped_sites: Dict[int, torch.Tensor] = {}
        for name, cin, cout, _, _ in _LAYERS:
            self.add_module(name, SparseConvBlock(
                in_channels if cin is None else cin, cout, device=device,
                generator=generator, dtype=dtype))

    def forward(self, st: SparseTensor,
                rulebook: Optional[Dict[str, torch.Tensor]] = None,
                with_maps: bool = False):
        """{x_conv1..x_conv4}; with ``with_maps`` also the layers' ConvMaps
        (ops/sparse_maps.py: backbone_maps, the strided inverse maps
        included) in the row order of the outputs, for a decoder."""
        rb = rulebook
        xw = self.x_window and rb is not None and "win_0" in rb
        if not xw and (rb is None or "nbr_0" not in rb):
            rb = device_rulebook(st.coords, st.valid, st.spatial_shape,
                                 self.max_voxels_per_stage)
            self.dropped_sites = {k: rb[f"dropped_{k}"] for k in (1, 2, 3)}
        f, coords, valid = st.features, st.coords, st.valid
        if xw:
            # the x-window maps address key-sorted rows: reorder stage 0 once
            order = rb["order_0"].long()
            f = torch.gather(f, 1, order[..., None].expand(-1, -1,
                                                            f.shape[2]))
            coords = torch.gather(coords, 1,
                                  order[..., None].expand(-1, -1, 3))
            valid = torch.gather(valid, 1, order)
        # explicit maps: the nbr-map path's forward, and the backward of both
        grad = torch.is_grad_enabled()
        maps = (backbone_maps(rb, key_sorted=xw, with_bwd=grad or with_maps)
                if grad or not xw or with_maps else {})
        shape = st.spatial_shape
        out = {}
        for name, _, _, k, strided in _LAYERS:
            if strided:
                count = rb[f"count_{k}"]
                coords = rb[f"coords_{k}"]
                valid = (torch.arange(coords.shape[1], device=count.device)
                         [None, :] < count[:, None])
                shape = stage_shape(shape, k)
            win_key, map_key = ((f"dwin_{k}", f"down_{k}") if strided
                                else (f"win_{k}", f"nbr_{k}"))
            win = rb[win_key] if xw else None
            f = getattr(self, name)(f, win, maps.get(map_key), valid)
            if name in _STAGE_OUTPUT:
                out[_STAGE_OUTPUT[name]] = SparseTensor(f, coords, valid,
                                                        shape)
        return (out, maps) if with_maps else out


class SparseConv3dDown(nn.Module):
    """A strided sparse conv of any (kz, ky, kx) kernel, per-axis stride and
    padding, without bias (models/sparse_backbone.py: SparseConv3dDown
    without a rulebook): the output active set and the gather map are built
    on the features' device (ops/device_rulebook.py), the smallest
    ``max_out_voxels`` output keys kept; the layer is a row gather and one
    matmul, differentiated by autograd. The detectors' conv_out, a (3, 1, 1)
    kernel at stride (2, 1, 1), is one; ``dropped_sites`` holds the (B,)
    output sites its cap cut off in the last forward. Weight layout:
    (kz * ky * kx, Cin, Cout) in (dz, dy, dx) scan order. At ``dtype``
    bfloat16 the gathered taps and the weights are rounded to bf16 and the
    product is one bf16 matmul (a float32 sum rounded once, as the JAX
    package's einsum outside any kernel, sparse_backbone.py:298-299)."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=2,
                 padding=1, max_out_voxels: int = 16000, *, device,
                 generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kz, ky, kx = ((kernel_size,) * 3 if isinstance(kernel_size, int)
                      else tuple(kernel_size))
        self.kernel_size = (kz, ky, kx)
        self.stride, self.padding = stride, padding
        self.max_out_voxels = max_out_voxels
        k3 = kz * ky * kx
        self.weight = nn.Parameter(draw((k3, cin, cout),
                                        (KAIMING / (k3 * cin)) ** 0.5,
                                        device=device, generator=generator))
        self.dropped_sites: Optional[torch.Tensor] = None

    def forward(self, st: SparseTensor) -> SparseTensor:
        args = (self.kernel_size, self.stride, self.padding)
        out_shape = conv_out_shape(st.spatial_shape, *args)
        with torch.no_grad():
            coords, valid, _, self.dropped_sites = downsample_active_set(
                st.coords, st.valid, out_shape, self.stride, self.padding,
                self.max_out_voxels, self.kernel_size)
            idx = down_map(st.coords, st.valid, st.spatial_shape, coords,
                           valid, self.stride, self.padding,
                           self.kernel_size)
        gathered = gather_taps(st.features, idx)             # (B, Mo, K, C)
        b, mo = idx.shape[:2]
        w = cast(self.weight.reshape(-1, self.weight.shape[-1]), self.dtype)
        out = cast(gathered.reshape(b, mo, -1), self.dtype) @ w
        out = out * valid[..., None].to(out.dtype)
        return SparseTensor(out, coords, valid, out_shape)


BACKBONE_STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
BACKBONE_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64,
                     "x_conv4": 64}
