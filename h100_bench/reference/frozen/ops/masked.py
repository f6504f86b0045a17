"""Masking primitives for the padded-actor design (ops/masked.py)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with positions where ``mask`` is False excluded;
    rows that are entirely masked return zeros."""
    logits = torch.where(mask, logits, NEG_INF)
    # the shift carries no gradient, as jax.lax.stop_gradient makes it
    m = torch.amax(logits, dim=dim, keepdim=True).detach()
    e = torch.exp(logits - m) * mask.to(logits.dtype)
    denom = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.clamp(denom, min=1e-20)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int,
               fill: float = NEG_INF) -> torch.Tensor:
    """Max of x over positions where mask is True (``fill`` where all are
    masked)."""
    return torch.amax(torch.where(mask, x, fill), dim=dim)
