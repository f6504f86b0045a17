"""Shared building blocks (models/layers.py): flax-semantics BatchNorm, the
MLP heads, the fusion FFN and seeded parameter initialisation.

Parameters are drawn from an explicit CPU ``torch.Generator`` and then
placed on the module's device, so one seed gives the same weights on every
device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

LECUN = 1.0        # flax lecun_normal: variance 1 / fan_in
KAIMING = 2.0      # flax kaiming_normal: variance 2 / fan_in


def draw(shape: Sequence[int], std: float, *, device,
         generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) values drawn on the CPU generator, moved to device."""
    return (torch.randn(tuple(shape), generator=generator) * std).to(device)


def linear(in_features: int, out_features: int, *, bias: bool = True,
           gain: float = LECUN, device, generator) -> nn.Linear:
    """Counterpart of flax ``nn.Dense``: weight (out, in) with variance
    gain / in, zero bias."""
    lin = skip_init(nn.Linear, in_features, out_features, bias=bias,
                    device=device)
    with torch.no_grad():
        lin.weight.copy_(draw((out_features, in_features),
                              (gain / in_features) ** 0.5, device=device,
                              generator=generator))
        if bias:
            lin.bias.zero_()
    return lin


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis, masked where rows are
    padded (flax ``MaskedBatchNorm``, models/layers.py:10-35).

    Eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``.
    Training: the batch mean and the biased variance ``E[x^2] - E[x]^2``
    (clipped at 0) over the rows where ``mask`` is True (all rows without
    a mask) normalise every row, and the running statistics move as
    ``r = momentum * r + (1 - momentum) * batch``. Both differ from
    ``torch.nn.BatchNorm1d``, whose momentum runs the other way and whose
    running variance is unbiased.
    """

    def __init__(self, num_features: int, eps: float, *, device,
                 momentum: float = 0.9, zero_scale: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        init = torch.zeros if zero_scale else torch.ones
        self.weight = nn.Parameter(init(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def affine(self):
        """(scale, shift) of the eval normalisation x * scale + shift."""
        if self.training:
            raise RuntimeError("BatchNorm.affine folds the running statistics"
                               ": it is defined in eval mode only")
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., C); mask broadcastable to x's leading dims, True on the
        rows that count in the training statistics."""
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * mul + self.bias
        rows = x.reshape(-1, x.shape[-1])
        if mask is None:
            mean = rows.mean(0)
            mean2 = (rows * rows).mean(0)
        else:
            m = torch.broadcast_to(mask, x.shape[:-1]).reshape(-1, 1)
            count = m.sum().to(x.dtype)
            mean = torch.where(m, rows, 0.0).sum(0) / count
            mean2 = torch.where(m, rows * rows, 0.0).sum(0) / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            mom = self.momentum
            self.running_mean.copy_(mom * self.running_mean
                                    + (1.0 - mom) * mean)
            self.running_var.copy_(mom * self.running_var
                                   + (1.0 - mom) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


# flax wraps nn.BatchNorm in MaskedBatchNorm to pass a row mask; the port's
# BatchNorm takes the mask itself, so both names are one class
MaskedBatchNorm = BatchNorm


class HeadMLP(nn.Module):
    """Linear -> ReLU -> Dropout(0.2) -> Linear -> softmax | sigmoid: the
    action and activity heads."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 activation: str, *, device, generator,
                 dropout_rate: float = 0.2):
        super().__init__()
        if activation not in ("softmax", "sigmoid"):
            raise ValueError(activation)
        self.activation = activation
        self.Dense_0 = linear(in_features, hidden, gain=KAIMING, device=device,
                              generator=generator)
        self.dropout = nn.Dropout(dropout_rate)
        self.Dense_1 = linear(hidden, out, gain=KAIMING, device=device,
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_1(self.dropout(F.relu(self.Dense_0(x))))
        if self.activation == "softmax":
            return torch.softmax(x, dim=-1)
        return torch.sigmoid(x)


class FFN(nn.Module):
    """Linear -> ReLU -> Linear, the fusion-block feed-forward."""

    def __init__(self, dim: int, *, device, generator):
        super().__init__()
        self.Dense_0 = linear(dim, dim, device=device, generator=generator)
        self.Dense_1 = linear(dim, dim, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))
