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

At bfloat16 (``model.dtype: bfloat16``: bf16 weights; the table is
rounded to bf16 where it comes in float32) the forward is the JAX package's
bf16 einsum over the gathered taps (models/sparse_backbone.py:169-173,
:268-299): the float32 sum of the exact products, rounded to bf16 once.
Its kernel is the tensor-core ``mgar_subm_conv_bf16`` of the same source
(csrc/gather_wgmma.cuh: wgmma and TMA), counted by
``subm_conv_bf16.launches``. Its backward follows XLA's VJP of
that gather + einsum, where the gather of the float32 table comes before
the cast:

- d(features), kernel C (``subm_conv_dgrad_bf16``, entry
  ``mgar_subm_conv_dgrad_bf16``): each (row, tap) product of dOut and the
  transposed weights rounded to bf16 once, widened, and the taps summed in
  float32, with no final rounding: a float32 d(features). On the card a
  64-row tile's taps are split over a thread-block cluster (wgmma on the
  forward core's warp-specialised ring), each block summing its
  contiguous share of the taps in ascending order and the blocks' sums
  added in rank order through distributed shared memory;
- d(weights), kernel D (ops/kernels/sparse_wgrad.py at bf16): the float32
  sum over every (row, tap) pair, rounded to bf16 once.
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
# its bf16 (forward) instances, at 16 input channels or more (narrower
# inputs are zero-padded to 16, ops/kernels/_pad.py):
#   (16, 16) (16, 32) (32, 32) (32, 64) (64, 64): VoxelBackbone8x (UNetV2's
#       encoder), the residual encoders' first three stages, UNetV2's
#       lateral blocks and inverse conv inv4, FocalSparseConv's feature conv;
#   (32, 16) (64, 32) (128, 64): UNetV2's up_m* merges and inverse convs
#       inv3 / inv2, PillarRes18Backbone's conv_input from a 64-wide VFE;
#   (64, 128) (128, 128): VoxelResBackbone8x's and VoxelNeXt's last stages,
#       VoxelNeXt's shared_conv, PillarRes18Backbone's third stage;
#   (256, 256): PillarRes18Backbone's last stage;
#   (32, 16) (64, 16): FocalSparseConv's importance conv, its one column
#       padded to D = 16 (detection/extras.py)
SUPPORTED_BF16 = frozenset({(16, 16), (16, 32), (32, 32), (32, 64),
                            (64, 64), (32, 16), (64, 32), (128, 64),
                            (64, 128), (128, 128), (256, 256), (64, 16)})
# kernel C's (D, C) pairs: the transposed pairs of those layers that take a
# data gradient (a backbone's first layer on the voxel features takes none;
# PillarRes18Backbone's, on a trainable VFE, does): the transposes of the
# forward set, with (16, 32) and (16, 64) from the importance convs
SUPPORTED_DGRAD_BF16 = frozenset({(16, 16), (32, 16), (32, 32), (64, 32),
                                  (64, 64), (16, 32), (32, 64), (64, 128),
                                  (128, 64), (128, 128), (256, 256),
                                  (16, 64)})


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_subm_conv_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_subm_conv_f32.restype = ctypes.c_int
    lib.mgar_subm_conv_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_subm_conv_bf16.restype = ctypes.c_int
    lib.mgar_subm_conv_dgrad_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_subm_conv_dgrad_bf16.restype = ctypes.c_int


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


def subm_conv_dgrad_bf16_plain(dout: torch.Tensor, idx: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Kernel C's plain version: bf16 dOut (B, M, D), the inverse map
    (B, R, 27) and the transposed bf16 weights (27, D, C) -> float32
    (B, R, C), ``out[b, r] = sum_k bf16(W[k]^T dout[b, idx[b, r, k]])``.
    Each tap's product is exact (float64 on the upcast operands) and
    rounded as XLA rounds its bf16 dot, the float32 sum to bf16; the taps
    are summed exactly and rounded to float32 once."""
    taps = torch.einsum("brkd,kdc->brkc", gather_taps(dout.double(), idx),
                        weights.double())
    return taps.float().to(torch.bfloat16).double().sum(2).float()


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_dtypes(name: str, table: torch.Tensor,
                 weights: torch.Tensor) -> None:
    """Raise TypeError unless the weights are float32 or bfloat16 (or
    float64 on the CPU, where the plain version runs: a reference free of
    float32 rounding) and the table is float32 or of the weights' dtype (a
    float32 table meets bf16 weights rounded to bf16, as the JAX layer
    casts its gathered taps)."""
    cpu64 = weights.dtype == torch.float64 \
        and weights.device.type == "cpu"
    if (weights.dtype not in (torch.float32, torch.bfloat16) and not cpu64) \
            or table.dtype not in (torch.float32, weights.dtype):
        raise TypeError(f"{name} takes float32 or bfloat16 weights (float64"
                        f" on the CPU) and a float32 table or one of the "
                        f"weights' dtype, got {table.dtype} and "
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


def _table(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The table a layer's kernel reads: at bf16 weights the features
    rounded to bf16 (a no-op on bf16 features), else the features."""
    if weights.dtype == torch.bfloat16:
        return features.to(torch.bfloat16)
    return features


class SparseConvFunction(torch.autograd.Function):
    """A sparse conv layer with the port's kernels in both directions.

    forward(features, weights, conv, maps): ``conv(table, weights)`` is the
    layer's forward (the x-window kernel or K3 over ``maps.fwd``), the
    table the features rounded to bf16 at bf16 weights (saved for K4 as
    such), the features themselves at float32.
    backward, d(features), skipped where the features need no gradient
    (the voxel features of conv_input): at float32 K3(dOut, maps.bwd,
    maps.dgrad_weights(W)); at bf16 kernel C over the same maps, float32
    whatever the table, in the features' dtype. d(weights): K4(table,
    maps.fwd, dOut), at bf16 kernel D's bf16 sum, which autograd widens to
    the float32 parameter.
    """

    @staticmethod
    def forward(ctx, features, weights, conv: Callable, maps: ConvMaps):
        table = _table(features, weights)
        ctx.save_for_backward(table, weights)
        ctx.maps = maps
        ctx.features_dtype = features.dtype
        return conv(table, weights)

    @staticmethod
    def backward(ctx, dout):
        table, weights = ctx.saved_tensors
        maps = ctx.maps
        dout = dout.contiguous()
        d_features = d_weights = None
        if ctx.needs_input_grad[0]:
            wt = maps.dgrad_weights(weights)
            if weights.dtype == torch.bfloat16:
                d_features = subm_conv_dgrad_bf16(dout, maps.bwd, wt).to(
                    ctx.features_dtype)
            else:
                d_features = _subm_forward(dout, maps.bwd, wt)
        if ctx.needs_input_grad[1]:
            # kernel D reads the map's tap columns, made once per map
            taps = dict(idx_taps=maps.fwd_taps) if table.is_cuda \
                and table.dtype == torch.bfloat16 else {}
            d_weights = sparse_wgrad(table.contiguous(), maps.fwd, dout,
                                     **taps)
        return d_features, d_weights, None, None


def sparse_conv(features: torch.Tensor, weights: torch.Tensor,
                conv: Callable, maps: Optional[ConvMaps]) -> torch.Tensor:
    """``conv(table, weights)`` (the table as SparseConvFunction makes
    it), through SparseConvFunction where a gradient is needed (which then
    requires the layer's ``maps``)."""
    if not _needs_grad(features, weights):
        return conv(_table(features, weights), weights)
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


def subm_conv_dgrad_bf16(dout: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Kernel C, the data gradient of a bf16 sparse conv: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors; same contract as
    :func:`subm_conv_dgrad_bf16_plain` (float32 out). No autograd of its
    own; its ``launches`` count the kernel's launches."""
    if dout.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"subm_conv_dgrad_bf16 takes bfloat16 dout and "
                        f"weights, got {dout.dtype} and {weights.dtype}")
    _check(dout, idx, weights)
    if dout.device.type == "cpu":
        return subm_conv_dgrad_bf16_plain(dout, idx, weights)
    if dout.device.type != "cuda":
        raise ValueError(f"subm_conv_dgrad_bf16 runs on cpu or cuda, not "
                         f"{dout.device}")
    b, m, d = dout.shape
    r, c = idx.shape[1], weights.shape[-1]
    if (d, c) not in SUPPORTED_DGRAD_BF16:
        raise ValueError(f"subm_conv_dgrad_bf16 kernel has no (D, C) = "
                         f"{(d, c)} instance; supported: "
                         f"{sorted(SUPPORTED_DGRAD_BF16)}")
    if not all(t.is_contiguous() for t in (dout, idx, weights)):
        raise ValueError("subm_conv_dgrad_bf16 kernel takes contiguous "
                         "tensors")
    if dout.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("subm_conv_dgrad_bf16 kernel needs a 16-byte "
                         "aligned dout and weights")
    out = torch.empty((b, r, c), dtype=torch.float32, device=dout.device)
    err = LIBRARY.load().mgar_subm_conv_dgrad_bf16(
        dout.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, r, m, d, c, stream_handle(dout.device))
    if err != 0:
        raise RuntimeError(f"subm_conv_dgrad_bf16 kernel launch failed: "
                           f"CUDA error {err}")
    subm_conv_dgrad_bf16.launches += 1
    return out


subm_conv_dgrad_bf16.launches = 0


def subm_conv_dgrad_bf16_cluster(b: int, r: int, d: int, c: int) -> int:
    """Kernel C's thread-block cluster at dF (b, r, c) from dOut of width d:
    the blocks one 64-row tile's taps are split over (on the card: builds
    the library)."""
    fn = LIBRARY.load().mgar_subm_conv_dgrad_bf16_cluster
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(b, r, d, c)
