"""The losses' denominator in one process (train/loss_lib.py: the part
MGAR's losses use)."""
from __future__ import annotations

import torch


def local_count(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a loss whose count spans the batch, in one
    process: the count, at least 1."""
    return count.clamp(min=1.0)
