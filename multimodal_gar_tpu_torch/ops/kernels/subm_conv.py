"""Index-map sparse conv (kernel 3) and the sparse convs' autograd.

Counterpart of ``multimodal_gar_tpu/ops/pallas/subm_conv.py:
subm_conv_pallas``: ``out[b, r] = sum_k W[k]^T table[b, idx[b, r, k]]``
over a (B, R, 27) int32 map with -1 absent, R != M allowed. The CUDA kernel
is ``csrc/subm_conv.cu``; ``subm_conv_plain`` is the package's
``subm_conv_xla`` in plain PyTorch: the wrapper takes it for CPU tensors
only, and the kernel is held to it on the card.

``SparseConvFunction`` is the backward of every sparse conv layer, whatever
its forward (the x-window kernel or this one): K3 maps dOut through the
layer's inverse map for d(features), K4 (ops/kernels/sparse_wgrad.py)
reduces the outer products for d(weights). The maps are
ops/sparse_maps.py's ``ConvMaps``.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..sparse_maps import ConvMaps, gather_taps
from ._build import KernelLibrary, stream_handle
from ._pad import ROUTES, conv_on_padded_table
from .sparse_wgrad import sparse_wgrad

# forward (C, D) pairs of the sparse backbones (VoxelBackbone8x, the
# residual ones to 128 channels, UNetV2's decoder, PillarRes18Backbone's
# 256-channel stage, FocalSparseConv's importance conv at D = 16, the input
# layer of 5 to 15 point features at (8, 16), (12, 16) and (16, 16):
# ops/kernels/_pad.py) and the transposed (D, C) pairs of their data
# gradients; csrc/subm_conv.cu instantiates these
SUPPORTED = frozenset({(4, 16), (8, 16), (12, 16), (16, 16), (16, 32), (32, 32),
                       (32, 64), (64, 64), (32, 16), (64, 32), (64, 128),
                       (128, 64), (128, 128), (64, 16), (16, 64), (256, 256)})


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_subm_conv_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_subm_conv_f32.restype = ctypes.c_int


LIBRARY = KernelLibrary("subm_conv", _bind)


def subm_conv_plain(table: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """subm_conv_xla: (B, M, C), (B, R, 27), (27, C, D) -> (B, R, D)."""
    return torch.einsum("brkc,kcd->brd", gather_taps(table, idx), weights)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check(table, idx, weights):
    if table.ndim != 3 or idx.ndim != 3 or idx.shape[-1] != 27:
        raise ValueError(f"table (B, M, C) and idx (B, R, 27) expected, got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if idx.shape[0] != table.shape[0]:
        raise ValueError("table and idx disagree on the batch size")
    if weights.ndim != 3 or weights.shape[:2] != (27, table.shape[-1]):
        raise ValueError(f"weights must be (27, {table.shape[-1]}, D), got "
                         f"{tuple(weights.shape)}")
    if table.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("subm_conv takes float32 tables and weights")
    if idx.dtype != torch.int32:
        raise TypeError("index maps must be int32")
    if idx.device != table.device or weights.device != table.device:
        raise ValueError("subm_conv inputs must share one device")


def _subm_forward(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors; no
    autograd."""
    if table.device.type == "cpu":
        return subm_conv_plain(table, idx, weights)
    if table.device.type != "cuda":
        raise ValueError(f"subm_conv runs on cpu or cuda, not {table.device}")
    if _needs_grad(table, weights):
        raise RuntimeError("the subm_conv kernel has no autograd of its own: "
                           "differentiate through SparseConvFunction")
    return conv_on_padded_table(_launch, table, idx, weights)


def _launch(table: torch.Tensor, idx: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors."""
    b, m, c = table.shape
    r, d = idx.shape[1], weights.shape[-1]
    if (c, d) not in SUPPORTED:
        raise ValueError(f"subm_conv kernel has no (C, D) = {(c, d)} "
                         f"instance (input width {c}); supported: "
                         f"{sorted(SUPPORTED)}, and " + ROUTES)
    if not all(t.is_contiguous() for t in (table, idx, weights)):
        raise ValueError("subm_conv kernel takes contiguous tensors")
    if table.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("subm_conv kernel needs a 16-byte aligned table and "
                         "weights")
    out = torch.empty((b, r, d), dtype=torch.float32, device=table.device)
    lib = LIBRARY.load()
    err = lib.mgar_subm_conv_f32(
        table.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, r, m, c, d, stream_handle(table.device))
    if err != 0:
        raise RuntimeError(f"subm_conv kernel launch failed: CUDA error {err}")
    subm_conv.launches += 1
    return out


class SparseConvFunction(torch.autograd.Function):
    """A sparse conv layer with the port's kernels in both directions.

    forward(features, weights, conv, maps): ``conv(features, weights)`` is
    the layer's forward (the x-window kernel or K3 over ``maps.fwd``).
    backward: d(features) = K3(dOut, maps.bwd, maps.dgrad_weights(W)),
    skipped where the features need no gradient (the voxel features of
    conv_input); d(weights) = K4(features, maps.fwd, dOut).
    """

    @staticmethod
    def forward(ctx, features, weights, conv: Callable, maps: ConvMaps):
        ctx.save_for_backward(features, weights)
        ctx.maps = maps
        return conv(features, weights)

    @staticmethod
    def backward(ctx, dout):
        features, weights = ctx.saved_tensors
        maps = ctx.maps
        dout = dout.contiguous()
        d_features = d_weights = None
        if ctx.needs_input_grad[0]:
            d_features = _subm_forward(dout, maps.bwd,
                                       maps.dgrad_weights(weights))
        if ctx.needs_input_grad[1]:
            d_weights = sparse_wgrad(features.contiguous(), maps.fwd, dout)
        return d_features, d_weights, None, None


def sparse_conv(features: torch.Tensor, weights: torch.Tensor,
                conv: Callable, maps: Optional[ConvMaps]) -> torch.Tensor:
    """``conv(features, weights)``, through SparseConvFunction where a
    gradient is needed (which then requires the layer's ``maps``)."""
    if not _needs_grad(features, weights):
        return conv(features, weights)
    if maps is None or maps.bwd is None:
        raise RuntimeError("a sparse conv's backward needs the layer's "
                           "explicit maps (ops/sparse_maps.py: ConvMaps)")
    return SparseConvFunction.apply(features, weights, conv, maps)


def subm_conv(table: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
              maps: Optional[ConvMaps] = None) -> torch.Tensor:
    """Index-map sparse conv: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; same contract as :func:`subm_conv_plain`.
    Differentiable when ``maps`` (whose ``fwd`` is ``idx``) are given."""
    _check(table, idx, weights)
    return sparse_conv(table, weights,
                       lambda f, w: _subm_forward(f, idx, w), maps)


subm_conv.launches = 0
