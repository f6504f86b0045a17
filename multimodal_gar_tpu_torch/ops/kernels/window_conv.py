"""Fused x-window 3x3x3 sparse conv, submanifold and strided (kernel 2).

Counterpart of ``multimodal_gar_tpu/ops/pallas/window_conv.py:
window_conv_band`` (and ``window_conv_pallas``), extended to output rows
R != table rows M so that it also runs the strided layers' ``dwin`` maps.
The CUDA kernel is ``csrc/window_conv.cu``; ``window_conv_plain`` is the
JAX package's XLA path (``window_gather`` + einsum) in plain PyTorch: the
wrapper takes it for CPU tensors only, and the kernel is held to it on the
card. Where a gradient is needed the layer runs through
ops/kernels/subm_conv.py's ``SparseConvFunction``: this kernel forward, K3
and K4 backward over the layer's explicit maps (ops/sparse_maps.py).

``window_conv_shifted`` is the same layer over a pre-shifted (M, 3C) table
with unpacked ``pos`` / ``sel`` maps, the counterpart of
``tools/probe_gather.py: probe_f``; a second entry of the same CUDA source.
It has no autograd: the probe has none.

At bfloat16 (``model.dtype: bfloat16``: features and weights bf16) the
layer is the JAX package's bf16 einsum (models/sparse_backbone.py:172-173,
:298-299): the float32 sum of the exact products, rounded to bf16 once.
Its kernel is the tensor-core ``mgar_window_conv_bf16`` of the same source
(csrc/gather_wgmma.cuh: wgmma and TMA), counted by
``window_conv_bf16.launches``. Its backward is SparseConvFunction's at
bf16 (kernels C and D over the layer's explicit maps).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..sparse_maps import ConvMaps
from ..voxel import WINDOW_POS_BITS, WINDOW_POS_MASK, shifted_window_table
from ._build import KernelLibrary, stream_handle
from ._pad import ROUTES, conv_on_padded_table
from .subm_conv import check_dtypes, sparse_conv

# (C, D) pairs of VoxelBackbone8x's 11 layers (MGAR's LiDAR backbone and
# the encoders of SECOND, CenterPoint, VoxelRCNN-Det and PartA2 on the
# x-window path), its input layer at 1 to 4 point features on (4, 16) and
# at 5 to 15 on (8, 16), (12, 16) and (16, 16) (ops/kernels/_pad.py);
# csrc/window_conv.cu instantiates exactly these
SUPPORTED = frozenset({(4, 16), (8, 16), (12, 16), (16, 16), (16, 32), (32, 32),
                       (32, 64), (64, 64)})
# the pairs of its bf16 instances: VoxelBackbone8x's (the same modules') at
# 16 input channels or more (narrower inputs are zero-padded to 16,
# ops/kernels/_pad.py); no other module has an x-window layer
SUPPORTED_BF16 = frozenset({(16, 16), (16, 32), (32, 32), (32, 64),
                            (64, 64)})
# the pairs csrc/window_conv.cu instantiates for window_conv_shifted
SUPPORTED_SHIFTED = frozenset({(16, 16), (32, 32), (64, 64)})


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_window_conv_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_window_conv_f32.restype = ctypes.c_int
    lib.mgar_window_conv_shifted_f32.argtypes = [p, p, p, p, p, i, i, i, i,
                                                 p]
    lib.mgar_window_conv_shifted_f32.restype = ctypes.c_int
    lib.mgar_window_conv_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mgar_window_conv_bf16.restype = ctypes.c_int


LIBRARY = KernelLibrary("window_conv", _bind)


def window_gather(features: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """All 27 tap rows of each query from a key-sorted stage.

    features (B, M, C) in linear-key order, win (B, R, 9) packed int32 maps
    -> (B, R, 27, C) in (dz, dy, dx) scan order, zeros where a tap is
    absent (models/sparse_backbone.py:48-78).
    """
    b, m, c = features.shape
    r = win.shape[1]
    wt = shifted_window_table(features)                   # (B, M, 3C)
    pos = (win & WINDOW_POS_MASK).long()
    sel = win >> WINDOW_POS_BITS
    bidx = torch.arange(b, device=features.device)[:, None, None]
    g = wt[bidx, pos].reshape(b, r, 9, 3, c)              # (B, R, 9, 3w, C)
    dx_shift = 2 * torch.arange(3, device=win.device, dtype=win.dtype)
    slots = (sel[..., None] >> dx_shift) & 3              # (B, R, 9, 3dx)
    onehot = (slots[..., None] == torch.arange(3, device=win.device)
              ).to(features.dtype)                        # (B, R, 9, 3dx, 3w)
    taps = torch.einsum("brpdw,brpwc->brpdc", onehot, g)
    return taps.reshape(b, r, 27, c)


def window_conv_plain(features: torch.Tensor, win: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """window_gather(features, win) @ weights: (B, M, C), (B, R, 9),
    (27, C, D) -> (B, R, D). At bfloat16 the float32 version on the upcast
    inputs, rounded to bf16 once."""
    if features.dtype == torch.bfloat16:
        return window_conv_plain(features.float(), win,
                                 weights.float()).to(torch.bfloat16)
    return torch.einsum("brkc,kcd->brd", window_gather(features, win),
                        weights)


def _check(features, win, weights):
    if features.ndim != 3 or win.ndim != 3 or win.shape[-1] != 9:
        raise ValueError(f"features (B, M, C) and win (B, R, 9) expected, got "
                         f"{tuple(features.shape)}, {tuple(win.shape)}")
    if win.shape[0] != features.shape[0]:
        raise ValueError("features and win disagree on the batch size")
    if weights.ndim != 3 or weights.shape[:2] != (27, features.shape[-1]):
        raise ValueError(f"weights must be (27, {features.shape[-1]}, D), got "
                         f"{tuple(weights.shape)}")
    check_dtypes("window_conv", features, weights)
    if win.dtype != torch.int32:
        raise TypeError("window maps must be int32")
    if win.device != features.device or weights.device != features.device:
        raise ValueError("window_conv inputs must share one device")


def window_conv(features: torch.Tensor, win: torch.Tensor,
                weights: torch.Tensor,
                maps: Optional[ConvMaps] = None) -> torch.Tensor:
    """Fused x-window sparse conv: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same contract as
    :func:`window_conv_plain`. Differentiable when the layer's ``maps``
    are given (their ``fwd`` decodes ``win``)."""
    _check(features, win, weights)
    return sparse_conv(features, weights,
                       lambda f, w: _window_forward(f, win, w), maps)


def _window_forward(features: torch.Tensor, win: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """The kernel or, for CPU tensors, the plain version; no autograd."""
    if features.device.type == "cpu":
        return window_conv_plain(features, win, weights)
    if features.device.type != "cuda":
        raise ValueError(f"window_conv runs on cpu or cuda, not "
                         f"{features.device}")
    return conv_on_padded_table(_launch, features, win, weights)


def _launch(features: torch.Tensor, win: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel of the features' dtype on CUDA tensors."""
    b, m, c = features.shape
    r, d = win.shape[1], weights.shape[-1]
    bf16 = features.dtype == torch.bfloat16
    pairs = SUPPORTED_BF16 if bf16 else SUPPORTED
    if (c, d) not in pairs:
        raise ValueError(f"window_conv {features.dtype} kernel has no "
                         f"(C, D) = {(c, d)} instance (input width {c}); "
                         f"supported: {sorted(pairs)}, and " + ROUTES)
    if not all(t.is_contiguous() for t in (features, win, weights)):
        raise ValueError("window_conv kernel takes contiguous tensors")
    if features.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("window_conv kernel needs 16-byte aligned features "
                         "and weights")
    out = torch.empty((b, r, d), dtype=features.dtype,
                      device=features.device)
    lib = LIBRARY.load()
    launch = lib.mgar_window_conv_bf16 if bf16 else lib.mgar_window_conv_f32
    err = launch(features.data_ptr(), win.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), b, r, m, c, d,
                 stream_handle(features.device))
    if err != 0:
        raise RuntimeError(f"window_conv {features.dtype} kernel launch "
                           f"failed: CUDA error {err}")
    (window_conv_bf16 if bf16 else window_conv).launches += 1
    return out


window_conv.launches = 0


def window_conv_bf16(features: torch.Tensor, win: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """:func:`window_conv` on bf16 features and weights; its ``launches``
    count the bf16 kernel's launches."""
    if features.dtype != torch.bfloat16:
        raise TypeError("window_conv_bf16 takes bfloat16 features")
    return window_conv(features, win, weights)


window_conv_bf16.launches = 0


def window_conv_shifted_plain(wt: torch.Tensor, pos: torch.Tensor,
                              sel: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_p sum_dx wt[pos[r, p], slot*C:(slot+1)*C] @ W[3p+dx]``
    with ``slot = (sel[r, p] >> 2*dx) & 3`` and slot 3 contributing zero:
    wt (M, 3C), pos and sel (R, 9) int32, weights (27, C, D) -> (R, D).
    Gather, select and einsum in plain PyTorch."""
    r = pos.shape[0]
    c = weights.shape[1]
    g = wt[pos.long()].reshape(r, 9, 3, c)                # (R, 9, 3w, C)
    dx_shift = 2 * torch.arange(3, device=sel.device, dtype=sel.dtype)
    slots = (sel[..., None] >> dx_shift) & 3              # (R, 9, 3dx)
    onehot = (slots[..., None] == torch.arange(3, device=sel.device)
              ).to(wt.dtype)                              # (R, 9, 3dx, 3w)
    taps = torch.einsum("rpdw,rpwc->rpdc", onehot, g).reshape(r, 27, c)
    return torch.einsum("rkc,kcd->rd", taps, weights)


def window_conv_shifted(wt: torch.Tensor, pos: torch.Tensor,
                        sel: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The 9-slot x-window conv over a pre-shifted table: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Same contract as
    :func:`window_conv_shifted_plain`; ``pos`` must lie in ``[0, M)``."""
    if wt.ndim != 2 or weights.ndim != 3 or weights.shape[0] != 27 \
            or wt.shape[1] != 3 * weights.shape[1]:
        raise ValueError(f"wt (M, 3C) and weights (27, C, D) expected, got "
                         f"{tuple(wt.shape)}, {tuple(weights.shape)}")
    if pos.ndim != 2 or pos.shape[1] != 9 or sel.shape != pos.shape:
        raise ValueError(f"pos and sel must both be (R, 9), got "
                         f"{tuple(pos.shape)}, {tuple(sel.shape)}")
    if wt.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("window_conv_shifted takes float32 tables and "
                        "weights")
    if pos.dtype != torch.int32 or sel.dtype != torch.int32:
        raise TypeError("pos and sel must be int32")
    if not (pos.device == sel.device == weights.device == wt.device):
        raise ValueError("window_conv_shifted inputs must share one device")
    if torch.is_grad_enabled() and (wt.requires_grad
                                    or weights.requires_grad):
        raise RuntimeError("window_conv_shifted has no autograd")
    if wt.device.type == "cpu":
        return window_conv_shifted_plain(wt, pos, sel, weights)
    if wt.device.type != "cuda":
        raise ValueError(f"window_conv_shifted runs on cpu or cuda, not "
                         f"{wt.device}")
    m, r = wt.shape[0], pos.shape[0]
    c, d = weights.shape[1:]
    if (c, d) not in SUPPORTED_SHIFTED:
        raise ValueError(f"window_conv_shifted kernel has no (C, D) = "
                         f"{(c, d)} instance; supported: "
                         f"{sorted(SUPPORTED_SHIFTED)}")
    if not all(t.is_contiguous() for t in (wt, pos, sel, weights)):
        raise ValueError("window_conv_shifted kernel takes contiguous "
                         "tensors")
    if wt.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("window_conv_shifted kernel needs a 16-byte aligned "
                         "table and weights")
    out = torch.empty((r, d), dtype=torch.float32, device=wt.device)
    lib = LIBRARY.load()
    err = lib.mgar_window_conv_shifted_f32(
        wt.data_ptr(), pos.data_ptr(), sel.data_ptr(), weights.data_ptr(),
        out.data_ptr(), r, m, c, d, stream_handle(wt.device))
    if err != 0:
        raise RuntimeError(f"window_conv_shifted kernel launch failed: CUDA "
                           f"error {err}")
    window_conv_shifted.launches += 1
    return out


window_conv_shifted.launches = 0
