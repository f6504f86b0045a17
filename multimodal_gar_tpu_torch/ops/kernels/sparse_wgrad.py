"""Weight gradient of the sparse conv (kernel 4).

``dW[k] = sum_{b, r} table[b, idx[b, r, k]]^T dout[b, r]``, (27, C, D), for
a layer whose forward is ``out[b, r] = sum_k W[k]^T table[b, idx[b, r, k]]``
(idx -1 absent). The JAX package leaves this to XLA (the VJP of
``window_gather`` + einsum, models/sparse_backbone.py:162-172); in the port
it is ``csrc/sparse_wgrad.cu``. On the card it is bound by the operations
of the (row, tap) pairs present, a few microseconds per layer, so the
kernel compacts each tap's present rows inside the block, gathers them
through a ``cp.async`` ring and multiplies only those; two launches (the
partial sums, then their reduction in a fixed order), no float atomics, so
two runs give the same bits. ``sparse_wgrad_plain`` is the einsum in plain
PyTorch: the wrapper takes it for CPU tensors only, and the kernel is held
to it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..sparse_maps import gather_taps
from ._build import KernelLibrary, stream_handle
from ._pad import WGRAD_ROUTES, wgrad_on_padded_table

# (C, D) pairs of the sparse backbones' layers (VoxelBackbone8x, the
# residual ones to 128 channels, UNetV2's decoder, PillarRes18Backbone's
# 256-channel stage, FocalSparseConv's importance conv at D = 16, the input
# layer of 5 to 7 point features at (8, 16) and of 9 to 15 at (16, 16):
# ops/kernels/_pad.py);
# csrc/sparse_wgrad.cu instantiates exactly these
SUPPORTED = frozenset({(4, 16), (8, 16), (16, 16), (16, 32), (32, 32),
                       (32, 64), (64, 64), (32, 16), (64, 32), (64, 128),
                       (128, 64), (128, 128), (64, 16), (256, 256)})


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_sparse_wgrad_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.mgar_sparse_wgrad_f32.restype = ctypes.c_int
    lib.mgar_sparse_wgrad_chunk.argtypes = []
    lib.mgar_sparse_wgrad_chunk.restype = ctypes.c_int
    # rows per (27, C, D) unit of scratch: a constant of the build
    lib.scratch_rows = lib.mgar_sparse_wgrad_chunk()


LIBRARY = KernelLibrary("sparse_wgrad", _bind)


def sparse_wgrad_plain(table: torch.Tensor, idx: torch.Tensor,
                       dout: torch.Tensor) -> torch.Tensor:
    """(B, M, C), (B, R, 27), (B, R, D) -> (27, C, D)."""
    return torch.einsum("brkc,brd->kcd", gather_taps(table, idx), dout)


def _check(table, idx, dout):
    if table.ndim != 3 or idx.ndim != 3 or idx.shape[-1] != 27 \
            or dout.ndim != 3:
        raise ValueError(f"table (B, M, C), idx (B, R, 27) and dout (B, R, D)"
                         f" expected, got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(dout.shape)}")
    if not (table.shape[0] == idx.shape[0] == dout.shape[0]
            and idx.shape[1] == dout.shape[1]):
        raise ValueError("table, idx and dout disagree on B or R")
    if table.dtype != torch.float32 or dout.dtype != torch.float32:
        raise TypeError("sparse_wgrad takes float32 tables and gradients")
    if idx.dtype != torch.int32:
        raise TypeError("index maps must be int32")
    if idx.device != table.device or dout.device != table.device:
        raise ValueError("sparse_wgrad inputs must share one device")


def sparse_wgrad(table: torch.Tensor, idx: torch.Tensor,
                 dout: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    same contract as :func:`sparse_wgrad_plain`. No autograd of its own."""
    _check(table, idx, dout)
    if table.device.type == "cpu":
        return sparse_wgrad_plain(table, idx, dout)
    if table.device.type != "cuda":
        raise ValueError(f"sparse_wgrad runs on cpu or cuda, not "
                         f"{table.device}")
    if torch.is_grad_enabled() and (table.requires_grad or dout.requires_grad):
        raise RuntimeError("the sparse_wgrad kernel has no autograd")
    return wgrad_on_padded_table(_launch, table, idx, dout)


def _launch(table: torch.Tensor, idx: torch.Tensor,
            dout: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel (its two grids) on CUDA tensors."""
    b, m, c = table.shape
    r, d = idx.shape[1], dout.shape[-1]
    if (c, d) not in SUPPORTED:
        raise ValueError(f"sparse_wgrad kernel has no (C, D) = {(c, d)} "
                         f"instance (input width {c}); supported: "
                         f"{sorted(SUPPORTED)}, and " + WGRAD_ROUTES)
    if not all(t.is_contiguous() for t in (table, idx, dout)):
        raise ValueError("sparse_wgrad kernel takes contiguous tensors")
    if table.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("sparse_wgrad kernel needs a 16-byte aligned table "
                         "and dout")
    lib = LIBRARY.load()
    partial = table.new_empty((-(-b * r // lib.scratch_rows), 27, c, d))
    dw = table.new_empty((27, c, d))
    err = lib.mgar_sparse_wgrad_f32(
        table.data_ptr(), idx.data_ptr(), dout.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), b, r, m, c, d, stream_handle(table.device))
    if err != 0:
        raise RuntimeError(f"sparse_wgrad kernel launch failed: CUDA error "
                           f"{err}")
    sparse_wgrad.launches += 1
    return dw


sparse_wgrad.launches = 0
