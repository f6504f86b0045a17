"""The sparse kernels' padded input layer.

The gather-GEMM kernels (csrc/gather_gemm.cuh) and K4 (csrc/sparse_wgrad.cu)
move table rows in 16-byte pieces, so their channel counts are multiples of
4. A first layer fed a point width between two instances (nuScenes' and
Lyft's time lag, Waymo's elongation and one-hot timestamps: 5 + n + 1
features for n past frames) runs the next wider instance on a copy of the
table widened by zero columns, with the weights widened by zero rows to
match: zero columns add zero, so the layer computes the same function. The
copy is a fresh contiguous tensor, so the kernels' 16-byte alignment holds.

The routes:
  - K3 and window_conv: widths 1-3 on their (4, D) instances (xyz-only
    point features, as data/custom.py trees may hold), 5-7 on (8, D), 9-11
    on (12, D), 13-15 on (16, D);
  - K4: widths 1-3 at 4, 5-7 at 8 and 9-15 at 16 (it has no 12-wide
    instance: padded
    to 16 it takes about the unpadded launch's time, where the gather-GEMM
    kernels take 1.5-2 times); it computes dW at the padded width and
    returns the first C rows of each tap, dropping the padding's rows.
  - at bfloat16, K3's and window_conv's tensor-core instances start at 16
    channels, the depth of one mma: widths 1-15 run on (16, D); so do
    kernel D's (K4 at bf16) in training, whose dW keeps the first C rows.
Other widths (4, 8, 12, 16 and the backbones' wider layers) go to the
kernel unchanged, which raises naming the width where it has no instance
of it: 17 and past, where no layer's pair is, among them.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

CONV_WIDTHS = {1: 4, 2: 4, 3: 4, 5: 8, 6: 8, 7: 8, 9: 12, 10: 12, 11: 12,
               13: 16, 14: 16, 15: 16}
WGRAD_WIDTHS = {1: 4, 2: 4, 3: 4, 5: 8, 6: 8, 7: 8,
                **{c: 16 for c in range(9, 16)}}
ROUTES = ("widths 1-3 padded to 4, 5-7 to 8, 9-11 to 12 and 13-15 to 16 "
          "(at bfloat16 1-15 to 16)")
WGRAD_ROUTES = ("widths 1-3 padded to 4, 5-7 to 8 and 9-15 to 16 (at "
                "bfloat16 1-15 to 16)")


def kernel_width(c: int, dtype: torch.dtype = torch.float32) -> int:
    """The table width K3 and window_conv run a layer of ``c`` input
    channels at, for tables of ``dtype``."""
    if dtype == torch.bfloat16:
        return max(c, 16)
    return CONV_WIDTHS.get(c, c)


def wgrad_width(c: int, dtype: torch.dtype = torch.float32) -> int:
    """The table width K4 runs a layer of ``c`` input channels at, for
    tables of ``dtype``."""
    if dtype == torch.bfloat16:
        return max(c, 16)
    return WGRAD_WIDTHS.get(c, c)


def conv_on_padded_table(launch: Callable, table: torch.Tensor, maps,
                         weights: torch.Tensor) -> torch.Tensor:
    """``launch(table, maps, weights)`` with a (B, M, C) table widened to
    ``kernel_width(C)`` columns and the (27, C, D) weights to as many
    rows."""
    c = table.shape[-1]
    width = kernel_width(c, table.dtype)
    if width == c:
        return launch(table, maps, weights)
    return launch(F.pad(table, (0, width - c)), maps,
                  F.pad(weights, (0, 0, 0, width - c)))


def wgrad_on_padded_table(launch: Callable, table: torch.Tensor,
                          idx: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """``launch(table, idx, dout)`` -> (27, C, D) with a table widened to
    ``wgrad_width(C)`` columns; the padding's rows of dW are dropped."""
    c = table.shape[-1]
    width = wgrad_width(c, table.dtype)
    if width == c:
        return launch(table, idx, dout)
    return launch(F.pad(table, (0, width - c)), idx, dout)[:, :c].contiguous()
