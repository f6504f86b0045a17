"""The I3D stem conv with the folded eval BatchNorm + ReLU, in plain
PyTorch: the port's ``stem_conv_plain``, which its stem kernel is held to.

``w2`` is the space-to-depth form of a 7x7x7 kernel (models/i3d.py:
``s2d_prep``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def stem_conv_sum(xd: torch.Tensor, w2: torch.Tensor,
                  t_pad: Tuple[int, int] = (3, 3)) -> torch.Tensor:
    """The stem's conv alone (no scale, bias or ReLU), NCDHW."""
    x = xd.permute(0, 4, 1, 2, 3)                        # NCDHW view
    if t_pad[0] != t_pad[1]:
        x = F.pad(x, (0, 0, 0, 0, t_pad[0], t_pad[1]))
        pad = 0
    else:
        pad = (t_pad[0], 0, 0)
    return F.conv3d(x, w2.permute(4, 3, 0, 1, 2), stride=(2, 1, 1),
                    padding=pad)


def stem_conv(xd: torch.Tensor, w2: torch.Tensor,
              scale: Optional[torch.Tensor], bias: torch.Tensor,
              t_pad: Tuple[int, int] = (3, 3), *,
              w2_is_s2d: bool = False) -> torch.Tensor:
    """relu(conv3d(xd, w2) * scale + bias).

    xd (B, T, Hp, Wp, 12) channels-last s2d input, w2 (7, 4, 4, 12, 64)
    DHWIO; stride (2, 1, 1), temporal zero pad ``t_pad``, H/W valid.
    Returns (B, 64, T_out, Hp - 3, Wp - 3) NCDHW. ``w2_is_s2d`` is the
    port's signature and changes nothing here.
    """
    y = stem_conv_sum(xd, w2, t_pad)
    return F.relu(y * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1))
