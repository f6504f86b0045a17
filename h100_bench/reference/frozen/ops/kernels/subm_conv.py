"""Index-map sparse conv and the sparse convs' autograd, in plain PyTorch:
the port's ``subm_conv_plain`` and ``sparse_wgrad_plain``, which its K3
and K4 kernels are held to, and its ``SparseConvFunction`` over them.

``out[b, r] = sum_k W[k]^T table[b, idx[b, r, k]]`` over a (B, R, 27) int32
map with -1 absent. The backward of every sparse conv layer, whatever its
forward: d(features) through the layer's inverse map, d(weights) the outer
products, over ops/sparse_maps.py's ``ConvMaps``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..sparse_maps import ConvMaps, gather_taps


def subm_conv_plain(table: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """(B, M, C), (B, R, 27), (27, C, D) -> (B, R, D)."""
    return torch.einsum("brkc,kcd->brd", gather_taps(table, idx), weights)


def sparse_wgrad_plain(table: torch.Tensor, idx: torch.Tensor,
                       dout: torch.Tensor) -> torch.Tensor:
    """dW[k] = sum_{b, r} table[b, idx[b, r, k]]^T dout[b, r]: (B, M, C),
    (B, R, 27), (B, R, D) -> (27, C, D)."""
    return torch.einsum("brkc,brd->kcd", gather_taps(table, idx), dout)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class SparseConvFunction(torch.autograd.Function):
    """A sparse conv layer: ``conv(features, weights)`` forward; backward
    d(features) = conv over ``maps.bwd`` with ``maps.dgrad_weights(W)``
    (skipped where the features need no gradient), d(weights) over
    ``maps.fwd``."""

    @staticmethod
    def forward(ctx, features, weights, conv: Callable, maps: ConvMaps):
        ctx.save_for_backward(features, weights)
        ctx.maps = maps
        return conv(features, weights)

    @staticmethod
    def backward(ctx, dout):
        table, weights = ctx.saved_tensors
        maps = ctx.maps
        dout = dout.contiguous()
        d_features = d_weights = None
        if ctx.needs_input_grad[0]:
            d_features = subm_conv_plain(dout, maps.bwd,
                                         maps.dgrad_weights(weights))
        if ctx.needs_input_grad[1]:
            d_weights = sparse_wgrad_plain(table.contiguous(), maps.fwd, dout)
        return d_features, d_weights, None, None


def sparse_conv(features: torch.Tensor, weights: torch.Tensor,
                conv: Callable, maps: Optional[ConvMaps]) -> torch.Tensor:
    """``conv(features, weights)``, through SparseConvFunction where a
    gradient is needed (which then requires the layer's ``maps``)."""
    if not _needs_grad(features, weights):
        return conv(features, weights)
    if maps is None or maps.bwd is None:
        raise RuntimeError("a sparse conv's backward needs the layer's "
                           "explicit maps (ops/sparse_maps.py: ConvMaps)")
    return SparseConvFunction.apply(features, weights, conv, maps)


def subm_conv(table: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
              maps: Optional[ConvMaps] = None) -> torch.Tensor:
    """Index-map sparse conv; differentiable when ``maps`` (whose ``fwd``
    is ``idx``) are given."""
    return sparse_conv(table, weights,
                       lambda f, w: subm_conv_plain(f, idx, w), maps)
