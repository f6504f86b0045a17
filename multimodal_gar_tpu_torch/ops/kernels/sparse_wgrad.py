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

At bfloat16 (a bf16 table and dOut, ``model.dtype: bfloat16`` training)
it is XLA's VJP of the bf16 einsum (models/sparse_backbone.py:172-173,
:298-299): the float32 sum over every (row, tap) pair, rounded to bf16
once. Kernel D, ``mgar_sparse_wgrad_bf16`` of the same source, is one
launch a layer with no scratch: a thread-block cluster per tap (and per
64 x 64 piece of dW[k] past 64 channels) whose blocks split the rows,
gather on mbarriers, multiply on the tensor cores (wgmma at D = 64,
mma.sync below) and add their float32 partials through distributed shared
memory in rank order before the one rounding. The wrapper returns
its bf16 dW, which autograd widens to the float32 parameter, and counts it
in ``sparse_wgrad_bf16.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..sparse_maps import gather_taps, tap_columns
from ._build import KernelLibrary, stream_handle
from ._pad import WGRAD_ROUTES, wgrad_on_padded_table

DTYPES = (torch.float32, torch.bfloat16)

# (C, D) pairs of the sparse backbones' layers (VoxelBackbone8x, the
# residual ones to 128 channels, UNetV2's decoder, PillarRes18Backbone's
# 256-channel stage, FocalSparseConv's importance conv at D = 16, the input
# layer of 5 to 7 point features at (8, 16) and of 9 to 15 at (16, 16):
# ops/kernels/_pad.py);
# csrc/sparse_wgrad.cu instantiates exactly these
SUPPORTED = frozenset({(4, 16), (8, 16), (16, 16), (16, 32), (32, 32),
                       (32, 64), (64, 64), (32, 16), (64, 32), (64, 128),
                       (128, 64), (128, 128), (64, 16), (256, 256)})
# kernel D's pairs: the bf16 forward's (ops/kernels/subm_conv.py:
# SUPPORTED_BF16 names the modules each serves), an input layer zero-padded
# to 16
SUPPORTED_BF16 = frozenset({(16, 16), (16, 32), (32, 32), (32, 64),
                            (64, 64), (32, 16), (64, 32), (128, 64),
                            (64, 128), (128, 128), (256, 256), (64, 16)})


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_sparse_wgrad_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.mgar_sparse_wgrad_f32.restype = ctypes.c_int
    lib.mgar_sparse_wgrad_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_sparse_wgrad_bf16.restype = ctypes.c_int
    lib.mgar_sparse_wgrad_chunk.argtypes = []
    lib.mgar_sparse_wgrad_chunk.restype = ctypes.c_int
    # rows per (27, C, D) unit of scratch: a constant of the build
    lib.scratch_rows = lib.mgar_sparse_wgrad_chunk()


LIBRARY = KernelLibrary("sparse_wgrad", _bind)


def sparse_wgrad_plain(table: torch.Tensor, idx: torch.Tensor,
                       dout: torch.Tensor) -> torch.Tensor:
    """(B, M, C), (B, R, 27), (B, R, D) -> (27, C, D). At bfloat16 the
    exact sum (float64 on the upcast operands) rounded as XLA rounds its
    bf16 dot, the float32 sum to bf16: a bf16 dW."""
    if table.dtype == torch.bfloat16:
        return sparse_wgrad_plain(table.double(), idx, dout.double()
                                  ).float().to(torch.bfloat16)
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
    cpu64 = table.dtype == torch.float64 and table.device.type == "cpu"
    if (table.dtype not in DTYPES and not cpu64) or dout.dtype != table.dtype:
        raise TypeError(f"sparse_wgrad takes float32 or bfloat16 tables "
                        f"(float64 on the CPU) and gradients of one dtype, "
                        f"got {table.dtype} and {dout.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError("index maps must be int32")
    if idx.device != table.device or dout.device != table.device:
        raise ValueError("sparse_wgrad inputs must share one device")


def sparse_wgrad(table: torch.Tensor, idx: torch.Tensor,
                 dout: torch.Tensor,
                 idx_taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA kernel of the table's dtype for CUDA tensors, the plain
    version for CPU tensors; same contract as :func:`sparse_wgrad_plain`
    (a bf16 dW at bf16). ``idx_taps`` is idx's (27, B R) tap columns
    (ops/sparse_maps.py: ConvMaps.fwd_taps), which kernel D reads; made
    here where it is not given. No autograd of its own."""
    _check(table, idx, dout)
    if table.device.type == "cpu":
        return sparse_wgrad_plain(table, idx, dout)
    if table.device.type != "cuda":
        raise ValueError(f"sparse_wgrad runs on cpu or cuda, not "
                         f"{table.device}")
    if torch.is_grad_enabled() and (table.requires_grad or dout.requires_grad):
        raise RuntimeError("the sparse_wgrad kernel has no autograd")
    return wgrad_on_padded_table(
        lambda t, i, d: _launch(t, i, d, idx_taps), table, idx, dout)


def _launch(table: torch.Tensor, idx: torch.Tensor, dout: torch.Tensor,
            idx_taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One call of the kernel on CUDA tensors: at float32 its two grids
    and a scratch of partial sums, at bf16 one launch."""
    b, m, c = table.shape
    r, d = idx.shape[1], dout.shape[-1]
    bf16 = table.dtype == torch.bfloat16
    pairs = SUPPORTED_BF16 if bf16 else SUPPORTED
    if (c, d) not in pairs:
        raise ValueError(f"sparse_wgrad {table.dtype} kernel has no (C, D) ="
                         f" {(c, d)} instance (input width {c}); supported: "
                         f"{sorted(pairs)}, and " + WGRAD_ROUTES)
    if not all(t.is_contiguous() for t in (table, idx, dout)):
        raise ValueError("sparse_wgrad kernel takes contiguous tensors")
    if table.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("sparse_wgrad kernel needs a 16-byte aligned table "
                         "and dout")
    lib = LIBRARY.load()
    dw = table.new_empty((27, c, d))
    stream = stream_handle(table.device)
    if bf16:
        if idx_taps is None:
            idx_taps = tap_columns(idx)
        if idx_taps.shape != (27, b * r) or idx_taps.dtype != torch.int32 \
                or not idx_taps.is_contiguous() \
                or idx_taps.device != idx.device:
            raise ValueError(f"idx_taps must be idx's contiguous (27, "
                             f"{b * r}) int32 tap columns, got "
                             f"{tuple(idx_taps.shape)} {idx_taps.dtype}")
        err = lib.mgar_sparse_wgrad_bf16(
            table.data_ptr(), idx_taps.data_ptr(), dout.data_ptr(),
            dw.data_ptr(), b, r, m, c, d, stream)
    else:
        # the float32 kernel's partial sums
        partial = torch.empty((-(-b * r // lib.scratch_rows), 27, c, d),
                              dtype=torch.float32, device=table.device)
        err = lib.mgar_sparse_wgrad_f32(
            table.data_ptr(), idx.data_ptr(), dout.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), b, r, m, c, d, stream)
    if err != 0:
        raise RuntimeError(f"sparse_wgrad {table.dtype} kernel launch "
                           f"failed: CUDA error {err}")
    (sparse_wgrad_bf16 if bf16 else sparse_wgrad).launches += 1
    return dw


sparse_wgrad.launches = 0


def sparse_wgrad_bf16(table: torch.Tensor, idx: torch.Tensor,
                      dout: torch.Tensor,
                      idx_taps: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """:func:`sparse_wgrad` on a bf16 table and dOut (kernel D); its
    ``launches`` count the bf16 kernel's launches."""
    if table.dtype != torch.bfloat16:
        raise TypeError("sparse_wgrad_bf16 takes a bfloat16 table")
    return sparse_wgrad(table, idx, dout, idx_taps)


sparse_wgrad_bf16.launches = 0


def sparse_wgrad_bf16_cluster() -> int:
    """Kernel D's thread-block cluster: the blocks one tap's rows are split
    over (on the card: builds the library)."""
    return LIBRARY.load().mgar_sparse_wgrad_bf16_cluster()
