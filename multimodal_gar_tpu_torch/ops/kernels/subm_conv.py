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

At bfloat16 (``model.dtype: bfloat16``: table and weights bf16) the forward
is the JAX package's bf16 einsum over the gathered taps
(models/sparse_backbone.py:169-173, :268-299): the float32 sum of the exact
products, rounded to bf16 once. Its kernel is the tensor-core
``mgar_subm_conv_bf16`` of the same source, counted by
``subm_conv_bf16.launches``. A bf16 sparse conv has no backward yet: where
a gradient is asked for it raises (ROADMAP Queue 1 item 4, bf16 training).
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
# its bf16 (forward) instances: VoxelBackbone8x's pairs at 16 input channels
# or more (narrower inputs are zero-padded to 16, ops/kernels/_pad.py)
SUPPORTED_BF16 = frozenset({(16, 16), (16, 32), (32, 32), (32, 64),
                            (64, 64)})
BF16_TRAINING = ("a bfloat16 sparse conv has no backward yet: bf16 training "
                 "is ROADMAP Queue 1 item 4")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_subm_conv_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_subm_conv_f32.restype = ctypes.c_int
    lib.mgar_subm_conv_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_subm_conv_bf16.restype = ctypes.c_int


LIBRARY = KernelLibrary("subm_conv", _bind)


def subm_conv_plain(table: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """subm_conv_xla: (B, M, C), (B, R, 27), (27, C, D) -> (B, R, D). At
    bfloat16 the float32 version on the upcast inputs, rounded to bf16
    once."""
    if table.dtype == torch.bfloat16:
        return subm_conv_plain(table.float(), idx,
                               weights.float()).to(torch.bfloat16)
    return torch.einsum("brkc,kcd->brd", gather_taps(table, idx), weights)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_dtypes(name: str, table: torch.Tensor,
                 weights: torch.Tensor) -> None:
    """Raise TypeError unless the table and the weights are both float32
    or both bfloat16."""
    if table.dtype not in (torch.float32, torch.bfloat16) \
            or weights.dtype != table.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 tables and "
                        f"weights of one dtype, got {table.dtype} and "
                        f"{weights.dtype}")


def _check(table, idx, weights):
    if table.ndim != 3 or idx.ndim != 3 or idx.shape[-1] != 27:
        raise ValueError(f"table (B, M, C) and idx (B, R, 27) expected, got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if idx.shape[0] != table.shape[0]:
        raise ValueError("table and idx disagree on the batch size")
    if weights.ndim != 3 or weights.shape[:2] != (27, table.shape[-1]):
        raise ValueError(f"weights must be (27, {table.shape[-1]}, D), got "
                         f"{tuple(weights.shape)}")
    check_dtypes("subm_conv", table, weights)
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
    """One launch of the kernel of the table's dtype on CUDA tensors."""
    b, m, c = table.shape
    r, d = idx.shape[1], weights.shape[-1]
    bf16 = table.dtype == torch.bfloat16
    pairs = SUPPORTED_BF16 if bf16 else SUPPORTED
    if (c, d) not in pairs:
        raise ValueError(f"subm_conv {table.dtype} kernel has no (C, D) = "
                         f"{(c, d)} instance (input width {c}); supported: "
                         f"{sorted(pairs)}, and " + ROUTES)
    if not all(t.is_contiguous() for t in (table, idx, weights)):
        raise ValueError("subm_conv kernel takes contiguous tensors")
    if table.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("subm_conv kernel needs a 16-byte aligned table and "
                         "weights")
    out = torch.empty((b, r, d), dtype=table.dtype, device=table.device)
    lib = LIBRARY.load()
    launch = lib.mgar_subm_conv_bf16 if bf16 else lib.mgar_subm_conv_f32
    err = launch(table.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), b, r, m, c, d, stream_handle(table.device))
    if err != 0:
        raise RuntimeError(f"subm_conv {table.dtype} kernel launch failed: "
                           f"CUDA error {err}")
    (subm_conv_bf16 if bf16 else subm_conv).launches += 1
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
    if features.dtype == torch.bfloat16:
        raise NotImplementedError(BF16_TRAINING)
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


def subm_conv_bf16(table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """:func:`subm_conv` on a bf16 table and weights; its ``launches``
    count the bf16 kernel's launches."""
    if table.dtype != torch.bfloat16:
        raise TypeError("subm_conv_bf16 takes a bfloat16 table")
    return subm_conv(table, idx, weights)


subm_conv_bf16.launches = 0
