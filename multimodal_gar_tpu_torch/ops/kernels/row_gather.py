"""Row gather: ``out[r, k*C:(k+1)*C] = table[idx[r, k]]``.

Counterpart of the gather probes of ``tools/probe_gather.py``: ``probe_a``
(27 rows per query) and ``probe_e`` (one row per query). The CUDA kernel is
``csrc/row_gather.cu``: bound by bytes at 27 rows per query, by the launch
and its chain of two dependent loads at one row per query, so each thread
keeps two independent copies in flight, the table is read through the
read-only path and the output leaves by streaming stores.
``row_gather_plain`` is the same function by
advanced indexing in plain PyTorch: the wrapper takes it for CPU tensors
only, and the kernel is held to it on the card (exactly: it is a copy).

Indices outside ``[0, M)``: the CPU path raises ``IndexError``; the kernel,
which cannot raise, writes such a row as zeros. No autograd: the probes
have none.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, stream_handle


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_row_gather_f32.argtypes = [p, p, p, i, i, ctypes.c_longlong, p]
    lib.mgar_row_gather_f32.restype = ctypes.c_int


LIBRARY = KernelLibrary("row_gather", _bind)


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, C), (R, K) -> (R, K * C) by advanced indexing."""
    r, k = idx.shape
    return table[idx.long()].reshape(r, k * table.shape[1])


def _check(table, idx):
    """What both paths require; returns (M, C, R, K)."""
    if table.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"table (M, C) and idx (R, K) expected, got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    m, c = table.shape
    if c % 4 or c == 0:
        raise ValueError(f"row width must be a multiple of 4, got {c}")
    if table.dtype != torch.float32:
        raise TypeError("row_gather takes a float32 table")
    if idx.dtype != torch.int32:
        raise TypeError("row indices must be int32")
    if idx.device != table.device:
        raise ValueError("row_gather inputs must share one device")
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("row_gather has no autograd")
    return (m, c, *idx.shape)


def _check_kernel(table, idx):
    """What the kernel requires beyond ``_check``."""
    if table.device.type != "cuda":
        raise ValueError(f"row_gather runs on cpu or cuda, not "
                         f"{table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather kernel takes contiguous tensors")
    if table.data_ptr() % 16:
        raise ValueError("row_gather kernel needs a 16-byte aligned table")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. table (M, C) float32 with C a multiple of 4, idx (R, K)
    int32 -> (R, K * C). Out-of-range indices raise on the CPU and read as
    zero rows on the card.

    At one row per query the kernel runs for a few microseconds, less than
    a call costs the host, so the wrapper does per call only what it must:
    the checks, one allocation, the raw stream handle and the ctypes call."""
    m, c, r, k = _check(table, idx)
    if table.device.type == "cpu":
        if idx.numel() and (idx.min() < 0 or idx.max() >= m):
            raise IndexError(f"row index outside [0, {m})")
        return row_gather_plain(table, idx)
    _check_kernel(table, idx)
    out = table.new_empty((r, k * c))
    if r * k == 0:
        return out
    err = LIBRARY.load().mgar_row_gather_f32(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, c, r * k,
        stream_handle(table.device))
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error "
                           f"{err}")
    row_gather.launches += 1
    return out


row_gather.launches = 0
