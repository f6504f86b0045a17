"""Inception-v1 I3D video backbone (models/i3d.py).

Public layout follows the JAX package: clips in as (B, T, H, W, 3) NDHWC,
features out as (B, T', H', W', C) NDHWC. Inside, the body runs NCDHW for
cuDNN. TF-SAME padding is explicit, including the asymmetric pads of the
stride-2 pools (by -inf) that ``F.max_pool3d`` cannot express.

Eval mode: the stem (Conv3d_1a_7x7) runs through the space-to-depth rewrite
and the hand-written stem kernel (ops/kernels/stem_conv.py) with the eval
BatchNorm folded into its epilogue. Every other Unit3D folds its eval
BatchNorm into the conv weights and bias. ``center_slice`` culls the
Mixed_4x modules to the temporal backward cone of Mixed_4f's center slice,
which is exact.

Training mode (the trainable I3D, ``i3d_freeze: false``): every Unit3D,
the stem included, runs conv -> training BatchNorm (flax semantics, eps
1e-3, momentum 0.99; the running statistics move) -> ReLU; the RGB branch
turns the cone cull off then (batch statistics over a culled extent would
differ). The stem's conv is then ``F.conv3d`` with autograd: the JAX
package runs XLA's conv there too and its Pallas stem only in eval
(``use_pallas ... and not train``), since the kernel has no backward; the
same model in eval mode launches the stem kernel again. ``dtype`` bfloat16
(``model.dtype``) runs the eval path as the JAX package does at bf16
(models/i3d.py:281-311): each conv's folded kernel ``kernel * s`` in
float32 rounded to bf16, the conv in bf16 (one rounding), the folded bias
added in bf16 (a second one), ReLU; the stem through the bf16 stem kernel,
which does both roundings in its epilogue. In training at bf16 each conv
is ``F.conv3d`` on the bf16-rounded input and kernel with a float32 sum,
the stem's too, as the JAX package trains it through XLA's bf16 s2d conv
(models/i3d.py:290-291) whose result XLA keeps in float32 for the
BatchNorm after it (``conv3d_bf16``); the training BatchNorm (flax's
``dtype=bf16``, models/i3d.py:314-316) takes float32 statistics and
rounds its result. ``remat`` recomputes each Inception
module's activations in the backward (``torch.utils.checkpoint``, as
``nn.remat`` in the JAX package); the recompute leaves the running
statistics alone, so outputs, gradients and statistics are those without.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.stem_conv import stem_conv
from .layers import LECUN, BatchNorm, draw, frozen_statistics

VALID_ENDPOINTS = (
    "Conv3d_1a_7x7", "MaxPool3d_2a_3x3", "Conv3d_2b_1x1", "Conv3d_2c_3x3",
    "MaxPool3d_3a_3x3", "Mixed_3b", "Mixed_3c", "MaxPool3d_4a_3x3",
    "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f",
    "MaxPool3d_5a_2x2", "Mixed_5b", "Mixed_5c",
)

ENDPOINT_CHANNELS = {
    "Mixed_3b": 256, "Mixed_3c": 480, "Mixed_4b": 512, "Mixed_4c": 512,
    "Mixed_4d": 512, "Mixed_4e": 528, "Mixed_4f": 832, "Mixed_5b": 832,
    "Mixed_5c": 1024,
}

# [b0, b1a, b1b, b2a, b2b, b3b] per module
_INCEPTION_CFG = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}

_POOLS = {
    "MaxPool3d_2a_3x3": ((1, 3, 3), (1, 2, 2)),
    "MaxPool3d_3a_3x3": ((1, 3, 3), (1, 2, 2)),
    "MaxPool3d_4a_3x3": ((3, 3, 3), (2, 2, 2)),
    "MaxPool3d_5a_2x2": ((2, 2, 2), (2, 2, 2)),
}

Pad = Tuple[int, int]


def _same_pad(dim: int, k: int, s: int) -> Pad:
    out = -(-dim // s)
    total = max((out - 1) * s + k - dim, 0)
    return total // 2, total - total // 2


def s2d_prep(x: torch.Tensor, w: torch.Tensor, even_width: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Space-to-depth the stem input and weights: x (B,T,H,W,C) ->
    xd (B,T,H/2+,W/2+,4C); w (7,7,7,C,O) DHWIO -> w2 (7,4,4,4C,O). The 7^3
    stride-2 stem then becomes a (7,4,4) stride-(2,1,1) conv with identical
    outputs. With ``even_width`` xd is the view of the first W/2+ pixels of
    rows of an even width (one zero pixel more where W/2+ is odd), written
    by the same copy: the layout the bf16 stem kernel's TMA reads
    (ops/kernels/stem_conv.py: even_rows)."""
    b, t, h, wd, c = x.shape
    kt, cout = w.shape[0], w.shape[-1]

    def axis_pad(dim):
        f, bk = _same_pad(dim, 7, 2)
        if (dim + f + bk) % 2:
            bk += 1
        return f, bk

    fh, bh = axis_pad(h)
    fw, bw = axis_pad(wd)
    qw = (wd + fw + bw) // 2
    extra = qw % 2 if even_width else 0
    xp = F.pad(x, (0, 0, fw, bw + 2 * extra, fh, bh))
    qh, width = xp.shape[2] // 2, xp.shape[3] // 2
    xd = xp.reshape(b, t, qh, 2, width, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    xd = xd.reshape(b, t, qh, width, 4 * c)[:, :, :, :qw]
    # w2[t, jh, jw, (eh, ew, c), o] = w[t, 2*jh+eh, 2*jw+ew, c, o]
    w8 = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))                   # zero tap 7
    w2 = w8.reshape(kt, 4, 2, 4, 2, c, cout).permute(0, 1, 3, 2, 4, 5, 6)
    return xd, w2.reshape(kt, 4, 4, 4 * c, cout)


def _flat(pads: Sequence[Pad]):
    """F.pad widths (last axis first) of per-axis (lo, hi) pads."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def max_pool_same(x: torch.Tensor, window: Tuple[int, int, int],
                  strides: Tuple[int, int, int],
                  t_pad: Optional[Pad] = None) -> torch.Tensor:
    """3D max pool of an NCDHW tensor with TF-SAME padding by -inf over
    (T, H, W); ``t_pad`` replaces the temporal pad in the cone-culled
    path."""
    pads = [_same_pad(d, k, s)
            for d, k, s in zip(x.shape[2:], window, strides)]
    if t_pad is not None:
        pads[0] = tuple(t_pad)
    if any(lo or hi for lo, hi in pads):
        x = F.pad(x, _flat(pads), value=-math.inf)
    return F.max_pool3d(x, window, strides)


class _ConvKernel(nn.Module):
    """Holds a conv weight (O, I, kD, kH, kW) at <name>.weight."""

    def __init__(self, cout: int, cin: int, kernel, *, device, generator):
        super().__init__()
        fan_in = cin * math.prod(kernel)
        self.weight = nn.Parameter(draw((cout, cin) + tuple(kernel),
                                        (LECUN / fan_in) ** 0.5,
                                        device=device, generator=generator))


def conv3d_bf16(x: torch.Tensor, weight: torch.Tensor, stride,
                padding) -> torch.Tensor:
    """A training Unit3D's bias-free conv3d at bf16: input and kernel
    rounded to bf16, their products summed in float32, and the float32 sum
    kept. XLA keeps it too: the conv's bf16 result goes straight into a
    BatchNorm that promotes it to float32, and XLA drops that round trip
    (measured on the CPU, tests/test_torch_bf16_train.py). A float32 conv
    of the upcast operands, which are exact in TF32 where cuDNN takes it."""
    x, weight = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    return F.conv3d(x.float(), weight.float(), None, stride, padding)


class Unit3D(nn.Module):
    """Conv3d (TF-SAME, no bias) + BatchNorm(eps=1e-3, momentum 0.99) +
    ReLU, NCDHW in and out. In eval mode the BatchNorm is folded into the
    conv; in training it normalises by the batch statistics.

    ``t_pad`` (3x3x3 convs of the cone-culled path): explicit temporal pad
    (pl, pr) instead of SAME; H/W stay SAME. ``dtype`` bfloat16: the eval
    conv in bf16 on the bf16-rounded folded kernel, + the folded bias in
    bf16, ReLU; in training the conv on bf16 operands (``conv3d_bf16``)
    and the BatchNorm's result rounded to bf16.
    """

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), *, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = _ConvKernel(cout, cin, kernel, device=device,
                                  generator=generator)
        self.bn = BatchNorm(cout, 1e-3, device=device, momentum=0.99,
                            channel_axis=1, dtype=dtype)

    def forward(self, x: torch.Tensor,
                t_pad: Optional[Pad] = None) -> torch.Tensor:
        pads = [_same_pad(d, k, st) for d, k, st in
                zip(x.shape[2:], self.kernel, self.stride)]
        if t_pad is not None:
            pads[0] = tuple(t_pad)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            x, padding = F.pad(x, _flat(pads)), 0
        if self.training:
            return F.relu(self.bn(conv3d_bf16(
                x, self.conv3d.weight, self.stride, padding)
                if self.dtype == torch.bfloat16 else F.conv3d(
                    x, self.conv3d.weight, None, self.stride, padding)))
        s, b = self.bn.affine()
        w = self.conv3d.weight * s.view(-1, 1, 1, 1, 1)
        if self.dtype == torch.float32:
            return F.relu(F.conv3d(x, w, b, self.stride, padding))
        y = F.conv3d(x.to(self.dtype), w.to(self.dtype), None, self.stride,
                     padding)
        return F.relu(y + b.to(self.dtype).view(1, -1, 1, 1, 1))


class StemUnit3D(Unit3D):
    """Conv3d_1a_7x7 (7^3, stride 2). Eval: through space-to-depth and the
    stem kernel, BN + ReLU in its epilogue. Training: ``F.conv3d`` with
    autograd and the training BatchNorm, as the JAX package runs XLA's conv
    in training. NDHWC clips in, NCDHW out; the weight stays at the
    canonical conv3d.weight. At bf16 the scale is folded into the kernel
    in float32 and rounded (models/i3d.py:289-291), and the bf16 stem
    kernel adds the bias."""

    def __init__(self, cin: int, cout: int, *, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, (7, 7, 7), (2, 2, 2), device=device,
                         generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x.permute(0, 4, 1, 2, 3))
        s, b = self.bn.affine()
        w = self.conv3d.weight.permute(2, 3, 4, 1, 0)            # DHWIO
        t_pad = _same_pad(x.shape[1], 7, 2)
        if self.dtype == torch.float32:
            xd, w2 = s2d_prep(x, w)
            return stem_conv(xd.contiguous(), w2.contiguous(), s, b,
                             t_pad=t_pad, w2_is_s2d=True)
        xd, w2 = s2d_prep(x.to(self.dtype), (w * s).to(self.dtype),
                          even_width=True)
        return stem_conv(xd, w2.contiguous(), None, b.to(self.dtype),
                         t_pad=t_pad, w2_is_s2d=True)


class InceptionModule(nn.Module):
    """Four-branch inception block, NCDHW. With ``t_pad`` the input covers
    exactly the temporal backward cone of the needed outputs: the 3x3x3
    branches pad (pl, pr) on T and the 1x1 branches slice to the center."""

    def __init__(self, cin: int, oc: Sequence[int], *, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.b0 = Unit3D(cin, oc[0], **kw)
        self.b1a = Unit3D(cin, oc[1], **kw)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), **kw)
        self.b2a = Unit3D(cin, oc[3], **kw)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), **kw)
        self.b3b = Unit3D(cin, oc[5], **kw)

    def forward(self, x: torch.Tensor,
                t_pad: Optional[Pad] = None) -> torch.Tensor:
        xc = x
        if t_pad is not None:
            pl, pr = t_pad
            xc = x[:, :, 1 - pl:x.shape[2] - (1 - pr)]
        b0 = self.b0(xc)
        b1 = self.b1b(self.b1a(x), t_pad)
        b2 = self.b2b(self.b2a(x), t_pad)
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1), t_pad))
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionI3d(nn.Module):
    """I3D feature extractor up to ``final_endpoint``.

    (B, T, H, W, 3) clips -> (B, T', H', W', C') features. With
    ``center_slice`` (Mixed_4f only) the output is (B, 1, H', W', 832),
    value-identical to the full output's center time slice in eval mode.
    ``remat``: the Inception modules recompute their activations in the
    backward of a training forward. ``dtype`` bfloat16: NDHWC bf16 features
    (every Unit3D at bf16).
    """

    def __init__(self, final_endpoint: str = "Mixed_4f",
                 center_slice: bool = False, remat: bool = False, *, device,
                 generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        if final_endpoint not in VALID_ENDPOINTS:
            raise ValueError(f"unknown endpoint {final_endpoint}")
        if center_slice and final_endpoint != "Mixed_4f":
            raise ValueError("center_slice is only defined for Mixed_4f")
        self.center_slice = center_slice
        self.remat = remat
        self.endpoints = VALID_ENDPOINTS[
            :VALID_ENDPOINTS.index(final_endpoint) + 1]
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.Conv3d_1a_7x7 = StemUnit3D(3, 64, **kw)
        cin = 64
        for ep in self.endpoints[1:]:
            if ep == "Conv3d_2b_1x1":
                self.add_module(ep, Unit3D(cin, 64, **kw))
                cin = 64
            elif ep == "Conv3d_2c_3x3":
                self.add_module(ep, Unit3D(cin, 192, (3, 3, 3), **kw))
                cin = 192
            elif ep in _INCEPTION_CFG:
                self.add_module(ep, InceptionModule(cin, _INCEPTION_CFG[ep],
                                                    **kw))
                cin = ENDPOINT_CHANNELS[ep]

    @staticmethod
    def _center_plan(t_in: int):
        """Backward temporal cone of Mixed_4f's center slice: the t_pad of
        each Mixed_4x module (None = uncull) and the [lo, hi) slice of the
        MaxPool3d_4a output that Mixed_4b consumes."""
        t1 = -(-t_in // 2)
        t4 = -(-t1 // 2)
        lo, hi = t4 // 2, t4 // 2 + 1
        plan = {}
        for ep in ("Mixed_4f", "Mixed_4e", "Mixed_4d", "Mixed_4c",
                   "Mixed_4b"):
            pl = 1 if lo == 0 else 0
            pr = 1 if hi == t4 else 0
            plan[ep] = None if (pl, pr) == (1, 1) else (pl, pr)
            lo, hi = max(lo - 1, 0), min(hi + 1, t4)
        return plan, (lo, hi)

    def _mixed(self, module: InceptionModule, x: torch.Tensor,
                t_pad: Optional[Pad]) -> torch.Tensor:
        """One Inception module; checkpointed under ``remat`` in a training
        forward that records a graph."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return module(x, t_pad)
        calls = []

        def run(inp):
            # the second call is the backward's recompute: the running
            # statistics moved in the first
            calls.append(None)
            with frozen_statistics(len(calls) > 1):
                return module(inp, t_pad)
        return checkpoint(run, x, use_reentrant=False,
                          preserve_rng_state=False)

    def forward(self, x: torch.Tensor,
                center_slice: Optional[bool] = None) -> torch.Tensor:
        """``center_slice`` overrides the constructor's setting for this
        call (the RGB branch turns the cull off while the I3D trains)."""
        if center_slice is None:
            center_slice = self.center_slice
        plan, entry = (self._center_plan(x.shape[1]) if center_slice
                       else ({}, None))
        x = self.Conv3d_1a_7x7(x)                          # NCDHW
        for ep in self.endpoints[1:]:
            if ep in _POOLS:
                x = max_pool_same(x, *_POOLS[ep])
                if ep == "MaxPool3d_4a_3x3" and entry is not None:
                    x = x[:, :, entry[0]:entry[1]]
            elif ep in _INCEPTION_CFG:
                x = self._mixed(getattr(self, ep), x, plan.get(ep))
            else:
                x = getattr(self, ep)(x)
        return x.permute(0, 2, 3, 4, 1)                    # NDHWC view
