"""The sparse kernels' padded input layer.

The gather-GEMM kernels (csrc/gather_gemm.cuh) and K4 (csrc/sparse_wgrad.cu)
move table rows in 16-byte pieces, so their channel counts are multiples of
4. A first layer fed 5 to 7 point features (nuScenes' and Lyft's time lag,
Waymo's elongation and timestamps) runs their (8, D) instances on a copy of
the table widened by zero columns, with the weights widened by zero rows to
match: zero columns add zero, so the layer computes the same function. The
copy is a fresh contiguous tensor, so the kernels' 16-byte alignment holds.
K4 computes dW at width 8 and returns the first C rows of each tap; the
padding's rows are dropped. Other widths go to the kernel unchanged, which
raises for a width it has no instance of (9 to 15 at the input layer).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

PADDED_WIDTHS = (5, 6, 7)
PADDED = 8


def kernel_width(c: int) -> int:
    """The table width the kernels run for a layer of ``c`` input channels."""
    return PADDED if c in PADDED_WIDTHS else c


def conv_on_padded_table(launch: Callable, table: torch.Tensor, maps,
                         weights: torch.Tensor) -> torch.Tensor:
    """``launch(table, maps, weights)`` with a (B, M, C) table of C in 5-7
    widened to 8 columns and the (27, C, D) weights to 8 rows."""
    c = table.shape[-1]
    width = kernel_width(c)
    if width == c:
        return launch(table, maps, weights)
    return launch(F.pad(table, (0, width - c)), maps,
                  F.pad(weights, (0, 0, 0, width - c)))


def wgrad_on_padded_table(launch: Callable, table: torch.Tensor,
                          idx: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """``launch(table, idx, dout)`` -> (27, C, D) with a table of C in 5-7
    widened to 8 columns; the padding's rows of dW are dropped."""
    c = table.shape[-1]
    width = kernel_width(c)
    if width == c:
        return launch(table, idx, dout)
    return launch(F.pad(table, (0, width - c)), idx, dout)[:, :c].contiguous()
