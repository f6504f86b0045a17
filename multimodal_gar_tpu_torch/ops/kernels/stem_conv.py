"""I3D stem conv with the folded eval BatchNorm + ReLU (kernel 1).

Counterpart of ``multimodal_gar_tpu/ops/pallas/stem_conv.py:
stem_conv_pallas``. The CUDA kernel is ``csrc/stem_conv.cu``; its source note
says what bounds it and how it is laid out. ``stem_conv_plain`` is the same
function in plain PyTorch: the wrapper takes it for CPU tensors only, and it
is what the kernel is held to on the card.

The wrapper's ``w2`` is the space-to-depth form of a 7x7x7 kernel
(models/i3d.py: ``s2d_prep``): the entries that stand for the 8th row and
column of the padded kernel are zero, and the CUDA kernel never reads them
(1029 products per output instead of 1344). ``s2d_zero_taps`` says which
entries those are and ``check_s2d_weights`` holds a ``w2`` to it; a ``w2``
that breaks the contract raises on either device.

At bfloat16 (the model's stem at ``model.dtype: bfloat16``) the eval
BatchNorm's scale is already folded into ``w2``, as the JAX package folds
it (models/i3d.py:289-291), so ``scale`` is None: the function is
``relu(bf16(bf16(conv3d(xd, w2)) + bias))``, the JAX package's XLA conv
rounded to bf16 and its bias add in bf16 (:290, :311). Its kernel is the
tensor-core ``mgar_stem_conv_bf16`` of the same source, counted by
``stem_conv_bf16.launches``; ``stem_conv.launches`` counts the float32
kernel's. That kernel (wgmma, TMA) reads xd in rows of an even number of
pixels (TMA strides are multiples of 16 bytes, a pixel is 24 bytes):
``models/i3d.py: s2d_prep(even_width=True)`` writes such rows and returns
the view of the real ones; the wrapper copies any other xd into them
(``even_rows``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import KernelLibrary, stream_handle

KT, KS, CIN, COUT = 7, 4, 12, 64


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_stem_conv_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.mgar_stem_conv_f32.restype = ctypes.c_int
    lib.mgar_stem_conv_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.mgar_stem_conv_bf16.restype = ctypes.c_int


LIBRARY = KernelLibrary("stem_conv", _bind)

# (data_ptr, version, device) of the w2 tensors that passed
# check_s2d_weights: a weight checked once costs no device read again
_CHECKED_W2: set = set()


def s2d_zero_taps() -> torch.Tensor:
    """(4, 4, 12) bool: the (kh, kw, channel) entries of ``w2`` that are
    structurally zero. Channel ``(eh * 2 + ew) * 3 + c`` of tap (kh, kw)
    holds tap (2 kh + eh, 2 kw + ew) of the 7x7 kernel padded to 8x8, so row
    and column 7 are the zero pad."""
    ch = torch.arange(CIN)
    eh, ew = ch // 6, (ch // 3) % 2
    k = torch.arange(KS)
    hh = 2 * k[:, None, None] + eh[None, None, :]
    ww = 2 * k[None, :, None] + ew[None, None, :]
    return (hh == 7) | (ww == 7)


def check_s2d_weights(w2: torch.Tensor) -> None:
    """Raise ValueError unless every structurally zero entry of ``w2``
    (7, 4, 4, 12, 64) is zero. Reads the device once per weight tensor and
    version: a ``w2`` that passed is remembered (an inference tensor has no
    version counter and is read every time)."""
    key = None if w2.is_inference() else (w2.data_ptr(), w2._version,
                                          str(w2.device))
    if key in _CHECKED_W2:
        return
    mask = s2d_zero_taps().to(w2.device)
    if bool((w2[:, mask] != 0).any()):
        raise ValueError("w2 is not the space-to-depth form of a 7x7x7 "
                         "kernel (models/i3d.py: s2d_prep): an entry of the "
                         "padded kernel's 8th row or column is not zero")
    if key is not None:
        if len(_CHECKED_W2) >= 64:
            _CHECKED_W2.clear()
        _CHECKED_W2.add(key)


def row_width(xd: torch.Tensor) -> Optional[int]:
    """The pixels per row of the buffer that xd (B, T, Hp, Wp, 12) is the
    first Wp pixels of, or None if xd is no such view: (C, pixel, row,
    frame, item) strides of 1, 12, 12 W, Hp 12 W and T Hp 12 W for some
    W >= Wp (a dimension of size 1 may have any stride)."""
    b, t, hp, wp, c = xd.shape
    width = xd.stride(2) // c if hp > 1 else wp
    want = (t * hp * width * c, hp * width * c, width * c, c, 1)
    if width < wp or any(n > 1 and st != w for n, st, w in
                         zip(xd.shape, xd.stride(), want)):
        return None
    return width


def even_rows(xd: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """xd as the first Wp pixels of rows of an even width, and that width:
    xd itself where it is already so laid out (models/i3d.py:
    s2d_prep(even_width=True)), else a copy into zero-padded rows."""
    width = row_width(xd)
    if width is not None and width % 2 == 0:
        return xd, width
    b, t, hp, wp, c = xd.shape
    width = wp + wp % 2
    rows = xd.new_zeros((b, t, hp, width, c))
    rows[..., :wp, :] = xd
    return rows[..., :wp, :], width


def _out_shape(xd: torch.Tensor, t_pad: Tuple[int, int]):
    b, t, hp, wp, _ = xd.shape
    t_out = (t + t_pad[0] + t_pad[1] - KT) // 2 + 1
    return b, COUT, t_out, hp - (KS - 1), wp - (KS - 1)


def stem_conv_plain(xd: torch.Tensor, w2: torch.Tensor,
                    scale: Optional[torch.Tensor], bias: torch.Tensor,
                    t_pad: Tuple[int, int] = (3, 3)) -> torch.Tensor:
    """relu(conv3d(xd, w2) * scale + bias) in plain PyTorch.

    xd (B, T, Hp, Wp, 12) channels-last s2d input, w2 (7, 4, 4, 12, 64)
    DHWIO; stride (2, 1, 1), temporal zero pad ``t_pad``, H/W valid.
    Returns (B, 64, T_out, Hp - 3, Wp - 3) NCDHW. At bfloat16 (``scale``
    None): the float32 conv of the upcast inputs rounded to bf16, plus the
    bf16 bias in bf16, then ReLU.
    """
    if xd.dtype == torch.bfloat16:
        y = stem_conv_sum(xd.float(), w2.float(), t_pad).to(torch.bfloat16)
        return F.relu(y + bias.view(1, -1, 1, 1, 1))
    y = stem_conv_sum(xd, w2, t_pad)
    return F.relu(y * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1))


def stem_conv_sum(xd: torch.Tensor, w2: torch.Tensor,
                  t_pad: Tuple[int, int] = (3, 3)) -> torch.Tensor:
    """The stem's conv alone (no scale, bias or ReLU), NCDHW, in the
    inputs' dtype: the sum the kernels' epilogues start from."""
    x = xd.permute(0, 4, 1, 2, 3)                        # NCDHW view
    if t_pad[0] != t_pad[1]:
        x = F.pad(x, (0, 0, 0, 0, t_pad[0], t_pad[1]))
        pad = 0
    else:
        pad = (t_pad[0], 0, 0)
    return F.conv3d(x, w2.permute(4, 3, 0, 1, 2), stride=(2, 1, 1),
                    padding=pad)


def _check(xd, w2, scale, bias, t_pad):
    if xd.dtype not in (torch.float32, torch.bfloat16) and not (
            xd.dtype == torch.float64 and xd.device.type == "cpu"):
        raise TypeError(f"stem_conv takes float32 or bfloat16 tensors "
                        f"(float64 on the CPU), not {xd.dtype}")
    bf16 = xd.dtype == torch.bfloat16
    if bf16 != (scale is None):
        raise ValueError("stem_conv takes a scale at float32 and none at "
                         "bfloat16 (the scale is folded into w2)")
    tensors = (xd, w2, bias) if bf16 else (xd, w2, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("stem_conv is forward-only: call it under "
                           "torch.no_grad()/inference_mode()")
    if xd.ndim != 5 or xd.shape[-1] != CIN:
        raise ValueError(f"xd must be (B, T, Hp, Wp, {CIN}), got "
                         f"{tuple(xd.shape)}")
    if tuple(w2.shape) != (KT, KS, KS, CIN, COUT):
        raise ValueError(f"w2 must be {(KT, KS, KS, CIN, COUT)}, got "
                         f"{tuple(w2.shape)}")
    if any(tuple(t.shape) != (COUT,) for t in tensors[2:]):
        raise ValueError("scale and bias must be (64,)")
    if any(t.dtype != xd.dtype for t in tensors):
        raise TypeError(f"stem_conv takes tensors of one dtype, float32 or "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if any(t.device != xd.device for t in tensors):
        raise ValueError("stem_conv inputs must share one device")
    if min(t_pad) < 0 or min(_out_shape(xd, t_pad)) <= 0:
        raise ValueError(f"no output for xd {tuple(xd.shape)}, t_pad {t_pad}")


def stem_conv(xd: torch.Tensor, w2: torch.Tensor,
              scale: Optional[torch.Tensor], bias: torch.Tensor,
              t_pad: Tuple[int, int] = (3, 3), *,
              w2_is_s2d: bool = False) -> torch.Tensor:
    """Fused stem conv: the CUDA kernel of the tensors' dtype (float32 or
    bfloat16) for CUDA tensors, the plain version for CPU tensors. Same
    contract as :func:`stem_conv_plain`, with ``w2`` the space-to-depth
    form of a 7x7x7 kernel. A caller that made ``w2`` with ``s2d_prep``
    says so with ``w2_is_s2d``; otherwise :func:`check_s2d_weights` holds
    it to the contract."""
    _check(xd, w2, scale, bias, t_pad)
    if not w2_is_s2d:
        check_s2d_weights(w2)
    if xd.device.type == "cpu":
        return stem_conv_plain(xd, w2, scale, bias, t_pad)
    if xd.device.type != "cuda":
        raise ValueError(f"stem_conv runs on cpu or cuda, not {xd.device}")
    bf16 = xd.dtype == torch.bfloat16
    if bf16:
        xd, width = even_rows(xd)
    if not all(t.is_contiguous() for t in (w2, scale, bias) if t is not None) \
            or not (bf16 or xd.is_contiguous()):
        raise ValueError("stem_conv kernel takes contiguous tensors")
    if xd.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("stem_conv kernel needs 16-byte aligned xd and w2")
    b, _, t_out, _, _ = shape = _out_shape(xd, t_pad)
    out = torch.empty(shape, dtype=xd.dtype, device=xd.device)
    lib = LIBRARY.load()
    if bf16:
        err = lib.mgar_stem_conv_bf16(
            xd.data_ptr(), w2.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            xd.shape[1], xd.shape[2], xd.shape[3], width, t_out, t_pad[0],
            stream_handle(xd.device))
        if err != 0:
            raise RuntimeError(f"stem_conv bf16 kernel launch failed: CUDA "
                               f"error {err}")
        stem_conv_bf16.launches += 1
        return out
    err = lib.mgar_stem_conv_f32(
        xd.data_ptr(), w2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, xd.shape[1], xd.shape[2], xd.shape[3], t_out,
        t_pad[0], stream_handle(xd.device))
    if err != 0:
        raise RuntimeError(f"stem_conv kernel launch failed: CUDA error {err}")
    stem_conv.launches += 1
    return out


stem_conv.launches = 0


def stem_conv_bf16(xd: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
                   t_pad: Tuple[int, int] = (3, 3), *,
                   w2_is_s2d: bool = False) -> torch.Tensor:
    """:func:`stem_conv` at bfloat16 (the scale folded into ``w2``); its
    ``launches`` count the bf16 kernel's launches."""
    return stem_conv(xd, w2, None, bias, t_pad, w2_is_s2d=w2_is_s2d)


stem_conv_bf16.launches = 0
