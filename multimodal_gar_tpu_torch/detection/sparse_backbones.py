"""The residual sparse encoder and the sparse UNet (PartA2)
(detection/sparse_backbones.py; pcdet spconv_backbone.py: SparseBasicBlock,
VoxelResBackBone8x, and spconv_unet.py: UNetV2).

Every 3x3x3 sparse layer runs through the port's kernels over explicit
maps (ops/sparse_maps.py: ConvMaps), as VoxelBackbone8x's do: K3 forward
over the maps' ``fwd``, and in training K3 for the data gradient over
``bwd`` and K4 for the weight gradient (ops/kernels/subm_conv.py:
SparseConvFunction).

- submanifold layers: ``fwd`` is the stage's neighbour map, mirrored;
- strided layers (stride 2, the stages' caps): ``fwd`` is the down map,
  ``bwd`` its inverse;
- the inverse conv (spconv's SparseInverseConv3d on an encoder layer's
  indice_key): its output active set is the encoder layer's input set, and
  fine row f gathers coarse row o at tap k where f = o * stride - pad + k,
  the same tap as the strided forward; so ``fwd`` is the encoder layer's
  inverse map and ``bwd`` its down map, not mirrored
  (``inverse_conv_maps``).

The maps are the host rulebook's where the batch carries them, else built
on the features' device (ops/device_rulebook.py).

``dtype`` bfloat16 (``DetectorConfig.dtype``) follows the JAX modules'
cast points, as VoxelBackbone8x's layers do (models/sparse_backbone.py):
each sparse conv, the inverse ones included, rounds its table and weights
to bf16 and runs the bf16 kernels (the forward core, kernel C and kernel
D), with a bf16 output; the BatchNorm after it returns float32, so the
residual sums, the decoder's concat and its channel reduction are float32,
as flax's are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm
from ..models.sparse_backbone import (SparseConv, SparseConvBlock,
                                      SparseTensor, VoxelBackbone8x)
from ..ops.device_rulebook import conv_out_shape, device_rulebook
from ..ops.sparse_maps import ConvMaps, backbone_maps, inverse_conv_maps


class SparseBasicBlock(nn.Module):
    """Residual submanifold block (spconv_backbone.py:30-67): conv + BN +
    ReLU -> conv + BN -> + identity -> ReLU, zero on padded rows; the convs
    at ``dtype``."""

    def __init__(self, channels: int, *, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.conv1 = SparseConv(channels, channels, **kw)
        self.bn1 = BatchNorm(channels, 1e-3, device=device, momentum=0.99)
        self.conv2 = SparseConv(channels, channels, **kw)
        self.bn2 = BatchNorm(channels, 1e-3, device=device, momentum=0.99)

    def forward(self, st: SparseTensor, maps: ConvMaps) -> SparseTensor:
        v = st.valid[..., None].to(st.features.dtype)
        f = F.relu(self.bn1(self.conv1(st.features, None, maps, st.valid),
                            st.valid)) * v
        f = self.bn2(self.conv2(f, None, maps, st.valid), st.valid)
        return dataclasses.replace(st, features=F.relu(f + st.features) * v)


def stage_maps(st: SparseTensor, rulebook: Optional[Dict[str, torch.Tensor]],
               caps, paddings) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, ConvMaps], Dict]:
    """(rulebook, ConvMaps, dropped sites per strided stage) of a stack of
    3^3 stages: the given rulebook where it carries the nbr maps of every
    stage, else maps built on the features' device."""
    rb = rulebook
    built = rb is None or any(f"nbr_{k}" not in rb for k in range(len(caps)))
    if built:
        rb = device_rulebook(st.coords, st.valid, st.spatial_shape, caps,
                             paddings)
    maps = backbone_maps(rb, key_sorted=False,
                         with_bwd=torch.is_grad_enabled())
    dropped = ({k: rb[f"dropped_{k}"] for k in range(1, len(caps))}
               if built else {})
    return rb, maps, dropped


def run_res_stages(mod: nn.Module, st: SparseTensor, rb, maps, paddings,
                   num_stages: int) -> Dict[int, SparseTensor]:
    """conv_input + res1_0/1, then per stage k >= 1 conv{k+1}_down +
    res{k+1}_0/1 over the stage's maps: the residual encoders' trunk.
    Returns each stage's output by stage index."""
    x = mod.conv_input(st.features, None, maps["nbr_0"], st.valid)
    x = dataclasses.replace(st, features=x)
    for j in (0, 1):
        x = getattr(mod, f"res1_{j}")(x, maps["nbr_0"])
    outs = {0: x}
    shape = st.spatial_shape
    for k in range(1, num_stages):
        count, coords = rb[f"count_{k}"], rb[f"coords_{k}"]
        valid = (torch.arange(coords.shape[1], device=count.device)[None]
                 < count[:, None])
        shape = conv_out_shape(shape, 3, 2, paddings[k])
        f = getattr(mod, f"conv{k + 1}_down")(x.features, None,
                                             maps[f"down_{k}"], valid)
        x = SparseTensor(f, coords, valid, shape)
        for j in (0, 1):
            x = getattr(mod, f"res{k + 1}_{j}")(x, maps[f"nbr_{k}"])
        outs[k] = x
    return outs


def add_res_stages(mod: nn.Module, in_channels: int, channels, *, device,
                   generator, dtype: torch.dtype = torch.float32) -> None:
    """The layers ``run_res_stages`` runs, one stage per channel width, the
    sparse convs at ``dtype``."""
    kw = dict(device=device, generator=generator, dtype=dtype)
    mod.conv_input = SparseConvBlock(in_channels, channels[0], **kw)
    for j in (0, 1):
        mod.add_module(f"res1_{j}", SparseBasicBlock(channels[0], **kw))
    for k in range(1, len(channels)):
        mod.add_module(f"conv{k + 1}_down", SparseConvBlock(
            channels[k - 1], channels[k], **kw))
        for j in (0, 1):
            mod.add_module(f"res{k + 1}_{j}", SparseBasicBlock(channels[k],
                                                               **kw))


RES_PADDINGS = ((1, 1, 1), (1, 1, 1), (1, 1, 1), (0, 1, 1))


class VoxelResBackbone8x(nn.Module):
    """Residual sparse encoder (VoxelResBackBone8x, spconv_backbone.py:
    184): channels 16/32/64/128, two SparseBasicBlocks per stage, the last
    stride with z padding 0. Returns {x_conv1..x_conv4}; ``dropped_sites``
    holds each strided stage's sites cut off by its cap where the maps were
    built on the device. ``dtype`` is the sparse convs' compute dtype."""

    def __init__(self, in_channels: int = 4, *, device, generator,
                 max_voxels_per_stage=(16000, 16000, 8000, 4000),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_voxels_per_stage = tuple(max_voxels_per_stage)
        self.dropped_sites: Dict[int, torch.Tensor] = {}
        add_res_stages(self, in_channels, (16, 32, 64, 128), device=device,
                       generator=generator, dtype=dtype)

    def forward(self, st: SparseTensor,
                rulebook: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, SparseTensor]:
        rb, maps, self.dropped_sites = stage_maps(
            st, rulebook, self.max_voxels_per_stage, RES_PADDINGS)
        outs = run_res_stages(self, st, rb, maps, RES_PADDINGS, 4)
        return {f"x_conv{k + 1}": outs[k] for k in range(4)}


# (lateral stage, lateral channels, bottom channels, merged, out) per UR
# block of UNetV2's decoder, coarsest first
_UR_BLOCKS = ((4, 64, 64, 64, 64), (3, 64, 64, 64, 32), (2, 32, 32, 32, 16),
              (1, 16, 16, 16, 16))


class UNetV2(nn.Module):
    """Sparse UNet (spconv_unet.py UNetV2): the port's VoxelBackbone8x as
    the encoder (``encoder``, on its rulebook paths: the x-window kernel
    where ``x_window`` is set and the rulebook carries its maps, K3 over
    the nbr maps otherwise) and a decoder of UR blocks back to stride 1.
    Returns (x_up1, the encoder's {x_conv1..4}): per-voxel 16-channel
    features on the input active set (in the encoder's stage-0 row order).
    ``dtype`` is every sparse conv's compute dtype, the encoder's and the
    decoder's."""

    def __init__(self, in_channels: int = 4, *, device, generator,
                 x_window: bool = False,
                 max_voxels_per_stage=(16000, 16000, 8000, 4000),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.encoder = VoxelBackbone8x(
            in_channels, x_window=x_window,
            max_voxels_per_stage=max_voxels_per_stage, **kw)
        for idx, lat, bottom, mid, out in _UR_BLOCKS:
            self.add_module(f"up_t{idx}", SparseBasicBlock(lat, **kw))
            self.add_module(f"up_m{idx}", SparseConvBlock(lat + bottom, mid,
                                                          **kw))
            last = f"up_out{idx}" if idx == 1 else f"inv{idx}"
            self.add_module(last, SparseConvBlock(mid, out, **kw))

    def _ur_block(self, idx: int, lateral: SparseTensor,
                  bottom: SparseTensor, fine: SparseTensor,
                  maps: Dict[str, ConvMaps]) -> SparseTensor:
        """UR_block_forward (spconv_unet.py:135-143): the lateral residual
        block, concat with the bottom, the merging subm conv plus the
        channel reduction (the concat's consecutive channel groups summed),
        then the inverse conv onto ``fine`` (the subm conv up_out1 at
        stride 1)."""
        nbr = maps[f"nbr_{idx - 1}"]
        x_trans = getattr(self, f"up_t{idx}")(lateral, nbr)
        cat = torch.cat([bottom.features, x_trans.features], -1)
        x_m = getattr(self, f"up_m{idx}")(cat, None, nbr, lateral.valid)
        mid = x_m.shape[-1]
        merged = x_m + cat.reshape(cat.shape[:-1]
                                   + (mid, cat.shape[-1] // mid)).sum(-1)
        if idx == 1:
            f = self.up_out1(merged, None, nbr, lateral.valid)
            return dataclasses.replace(lateral, features=f)
        inv = inverse_conv_maps(maps[f"down_{idx - 1}"])
        f = getattr(self, f"inv{idx}")(merged, None, inv, fine.valid)
        return dataclasses.replace(fine, features=f)

    def forward(self, st: SparseTensor,
                rulebook: Optional[Dict[str, torch.Tensor]] = None):
        ms, maps = self.encoder(st, rulebook, with_maps=True)
        x = [ms[f"x_conv{k}"] for k in (1, 2, 3, 4)]
        up = x[3]
        for (idx, *_), fine in zip(_UR_BLOCKS, (x[2], x[1], x[0], x[0])):
            up = self._ur_block(idx, x[idx - 1], up, fine, maps)
        return up, ms
