"""Shared building blocks (models/layers.py): flax-semantics BatchNorm, the
MLP heads, the fusion FFN, multi-head attention in flax's layout, dropout
on a generator of the model's own, and seeded parameter initialisation.

Parameters are drawn from an explicit CPU ``torch.Generator`` and then
placed on the module's device, so one seed gives the same weights on every
device.

Compute dtypes (``model.dtype: bfloat16``): parameters stay float32, as
flax keeps them, and a module casts at the point of use. A flax module
given ``dtype`` casts its inputs and parameters to it and returns it
(``dense``, ``BatchNorm(dtype=)``); one given no dtype computes in the
promoted type of its inputs and its float32 parameters, which is float32
here, whatever the input's dtype. A bf16 product or conv is a float32 sum
rounded once; a bias added to it is rounded again (flax adds it in the
dtype), and every elementwise op in bf16 rounds, with a Python number
rounded to bf16 first (JAX's weak types): ``scalar`` gives that number.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

LECUN = 1.0        # flax lecun_normal: variance 1 / fan_in
KAIMING = 2.0      # flax kaiming_normal: variance 2 / fan_in

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """``model.dtype`` / ``DetectorConfig.dtype`` -> the backbones' compute
    dtype; anything but "float32" or "bfloat16" raises."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: the port computes in float32 or "
                         f"bfloat16")
    return DTYPES[name]


def scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python number as a 0-dim tensor of ``dtype``: at bf16 the number
    rounded to bf16 before it meets a bf16 tensor, as JAX rounds a weakly
    typed Python scalar (torch would compute with it unrounded)."""
    return torch.tensor(value, dtype=dtype)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a module's compute ``dtype``: cast at bf16; at float32, the
    default, left as it is (a module without a flax dtype computes in the
    promoted type of its input and parameters, float64 included)."""
    return x if dtype == torch.float32 else x.to(dtype)


class _LinearOfFloat32(torch.autograd.Function):
    """``F.linear(x.to(bf16), w)`` of a float32 ``x`` and bf16 ``w``, whose
    backward gives d(x) as the float32 product of the bf16 cotangent and
    weights, unrounded: XLA drops the bf16 round trip of the dot that the
    widening cast of JAX's VJP follows (measured on the CPU,
    tests/test_torch_bf16_train.py: test_dense_vjp_matches_jax_bf16).
    d(w) is the bf16 product, rounded once, as autograd's."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.to(torch.bfloat16)
        ctx.save_for_backward(xb, w)
        return F.linear(xb, w)

    @staticmethod
    def backward(ctx, dy):
        xb, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dy.float() @ w.float()
        if ctx.needs_input_grad[1]:
            dw = dy.reshape(-1, dy.shape[-1]).T @ xb.reshape(-1, xb.shape[-1])
        return dx, dw


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with the weights of ``layer``: at bf16
    the input, kernel and bias cast to bf16, the product rounded once and
    the bias added in bf16 (a float32 input's gradient through
    ``_LinearOfFloat32``). At float32 (flax's ``dtype=None``) ``layer`` on
    the input promoted with its weights (a bf16 input computes in
    float32)."""
    if dtype == torch.float32:
        return layer(x.to(torch.promote_types(x.dtype, layer.weight.dtype)))
    w = layer.weight.to(dtype)
    if x.dtype == torch.float32 and torch.is_grad_enabled() \
            and x.requires_grad:
        y = _LinearOfFloat32.apply(x, w)
    else:
        y = F.linear(x.to(dtype), w)
    return y if layer.bias is None else y + layer.bias.to(dtype)


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


_FROZEN_STATISTICS = [0]


@contextlib.contextmanager
def frozen_statistics(frozen: bool = True) -> Iterator[None]:
    """Within it (where ``frozen``), training BatchNorms normalise by the
    batch statistics as always but leave their running statistics alone:
    the recomputed forward of a checkpointed block must not move them a
    second time."""
    _FROZEN_STATISTICS[0] += int(frozen)
    try:
        yield
    finally:
        _FROZEN_STATISTICS[0] -= int(frozen)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis (the last unless
    ``channel_axis`` says otherwise), masked where rows are padded (flax
    ``MaskedBatchNorm``, models/layers.py:10-35).

    Eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``.
    Training: the batch mean and the biased variance ``E[x^2] - E[x]^2``
    (clipped at 0) over the rows where ``mask`` is True (all rows without
    a mask) normalise every row, and the running statistics move as
    ``r = momentum * r + (1 - momentum) * batch``. Both differ from
    ``torch.nn.BatchNorm1d``, whose momentum runs the other way and whose
    running variance is unbiased.

    ``dtype``: bfloat16 where flax's BatchNorm is given that dtype: the
    normalisation runs in float32 on the promoted input, as flax's does,
    and its result is rounded once. At float32, the default, the result
    stays in the promoted dtype (flax's ``dtype=None``), float32 on a bf16
    input. In training a bf16 input's statistics are taken in float32 and
    the running statistics move in float32, as flax's do.

    ``data_group`` (set by parallel/mesh.py: ``attach``, None by default):
    a process group of the mesh's data axis, over whose ranks the training
    statistics are taken. The sums (x, x^2 and the count) go through one
    autograd-aware all-reduce, so the statistics and their gradients are
    those of the global batch (``torch.nn.SyncBatchNorm`` merges Welford
    statistics and keeps the torch running statistics instead).
    """

    data_group = None

    def __init__(self, num_features: int, eps: float, *, device,
                 momentum: float = 0.9, zero_scale: bool = False,
                 channel_axis: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.momentum = momentum
        self.channel_axis = channel_axis
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
        """x (..., C) (C on ``channel_axis``); mask broadcastable to x's
        leading dims, True on the rows that count in the training
        statistics (channel-last only)."""
        view = [1] * x.ndim
        view[self.channel_axis] = -1
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x - self.running_mean.view(view)) * mul.view(view) \
                + self.bias.view(view)
            return cast(y, self.dtype)
        # flax takes the statistics of a bf16 input in float32 (a cast of
        # its own) and normalises the input promoted to float32 (another):
        # two casts, so that autograd rounds each path's gradient to bf16
        # before the two meet, as XLA's VJP does
        xs = x.float() if x.dtype == torch.bfloat16 else x
        if x.dtype == torch.bfloat16:
            x = x.float()
        axis = self.channel_axis % x.ndim
        c = x.shape[axis]
        if axis != x.ndim - 1:
            dims = [d for d in range(x.ndim) if d != axis]
            s1, s2 = xs.sum(dims), (xs * xs).sum(dims)
            count = x.numel() // c
        else:
            rows = xs.reshape(-1, c)
            if mask is None:
                count = rows.shape[0]
            else:
                m = torch.broadcast_to(mask, x.shape[:-1]).reshape(-1, 1)
                rows = torch.where(m, rows, 0.0)
                count = m.sum().to(x.dtype)
            s1, s2 = rows.sum(0), (rows * rows).sum(0)
        if self.data_group is not None:
            s1, s2, count = _all_reduce_sums(s1, s2, count, self.data_group)
        mean, mean2 = s1 / count, s2 / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if not _FROZEN_STATISTICS[0]:
            with torch.no_grad():
                mom = self.momentum
                self.running_mean.copy_(mom * self.running_mean
                                        + (1.0 - mom) * mean)
                self.running_var.copy_(mom * self.running_var
                                       + (1.0 - mom) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(view)) * mul.view(view) + self.bias.view(view)
        return cast(y, self.dtype)


def _all_reduce_sums(s1: torch.Tensor, s2: torch.Tensor, count, group):
    """(s1, s2, count) summed over the ranks of ``group`` in one
    autograd-aware all-reduce (its backward sums the ranks' gradients)."""
    from torch.distributed.nn.functional import all_reduce
    c = s1.shape[0]
    count = torch.as_tensor(count, dtype=s1.dtype, device=s1.device)
    with warnings.catch_warnings():
        # newer torch releases point to _functional_collectives, whose
        # autograd older releases lack
        warnings.simplefilter("ignore", FutureWarning)
        total = all_reduce(torch.cat([s1, s2, count.reshape(1)]),
                           group=group)
    return total[:c], total[c:2 * c], total[-1]


# flax wraps nn.BatchNorm in MaskedBatchNorm to pass a row mask; the port's
# BatchNorm takes the mask itself, so both names are one class
MaskedBatchNorm = BatchNorm


class Dropout(nn.Dropout):
    """``nn.Dropout`` that draws its mask from ``generator`` (on the input's
    device) instead of torch's global stream. ``seed_dropout`` gives every
    Dropout of a model one generator and reseeds it per training step, so
    the masks follow (seed, step) and the caller's global stream does not
    move. Without a generator it draws from the global stream.

    ``shard`` (set by parallel/mesh.py: ``attach``): (rank, size) of the
    mesh's data axis; the layer then draws the mask of the global batch,
    ``size`` times its input's rows, and keeps its rank's block, so that
    the ranks together drop what one process on the global batch would."""

    generator: Optional[torch.Generator] = None
    shard: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if self.shard is None:
            mask = torch.empty_like(x).bernoulli_(keep,
                                                  generator=self.generator)
        else:
            rank, size = self.shard
            b = x.shape[0]
            mask = x.new_empty((size * b,) + tuple(x.shape[1:])).bernoulli_(
                keep, generator=self.generator)[rank * b:(rank + 1) * b]
        return x * mask / keep


def seed_dropout(model: nn.Module, seed: int, step: int) -> None:
    """Seed the dropout of ``model`` for the micro-step ``step`` of a run
    seeded ``seed``: every ``Dropout`` draws from one generator on the
    model's device (made at the first call), reseeded here."""
    gen = getattr(model, "_dropout_generator", None)
    if gen is None:
        device = next(model.parameters()).device
        gen = torch.Generator(device=device)
        model._dropout_generator = gen       # no parameter and no buffer
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = gen
    # a well-mixed word of (seed, step): torch's CPU generator keeps only
    # the low 32 bits of its seed
    lo, hi = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    gen.manual_seed((int(hi) << 32) | int(lo))


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (no dropout): ``query``,
    ``key``, ``value`` and ``out`` projections with biases, ``num_heads``
    heads of width dim / num_heads, logits of q / sqrt(width) against k,
    masked positions at the dtype's lowest value before the softmax (a row
    with every position masked attends uniformly, as in flax). flax keeps
    the projections as (D, H, D/H) and (H, D/H, D) kernels; here they are
    Linear layers over the flattened head axes (convert.py reshapes)."""

    def __init__(self, dim: int, num_heads: int, *, device, generator):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is no multiple of {num_heads} heads")
        self.num_heads = num_heads
        kw = dict(device=device, generator=generator)
        self.query = linear(dim, dim, **kw)
        self.key = linear(dim, dim, **kw)
        self.value = linear(dim, dim, **kw)
        self.out = linear(dim, dim, **kw)

    def forward(self, q_src: torch.Tensor, kv_src: torch.Tensor,
                pair_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q_src (B, N, D), kv_src (B, M, D), pair_valid (B, N, M) bool
        (None: every pair)."""
        b, n, d = q_src.shape
        h = self.num_heads

        def heads(x):
            return x.reshape(b, -1, h, d // h).transpose(1, 2)  # (B,H,.,D/H)
        q = heads(self.query(q_src)) / (d // h) ** 0.5
        k, v = heads(self.key(kv_src)), heads(self.value(kv_src))
        logits = q @ k.transpose(2, 3)                           # (B,H,N,M)
        if pair_valid is not None:
            logits = torch.where(pair_valid[:, None], logits,
                                 torch.finfo(logits.dtype).min)
        att = torch.softmax(logits, dim=-1)
        return self.out((att @ v).transpose(1, 2).reshape(b, n, d))


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
        self.dropout = Dropout(dropout_rate)
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
