"""Label engineering: the 27-action -> 7-partition split of the heads
(train/labels.py:20-50)."""
from __future__ import annotations

from typing import Tuple

import torch


def partition_action_labels(actions: torch.Tensor, valid: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """Split (B, N, 27) multi-hot actions into the 7 head partitions, zero
    on padded rows.

    Indices 10, 25 and 26 are skipped, a reference quirk kept for parity:
      pose_1    = a[0:3]   ++ max(a[3:10])     -> (B, N, 4)
      pose_2    = a[3:6]   ++ max(a[6:10])     -> (B, N, 4)
      pose_3    = a[6:10]                      -> (B, N, 4)
      intrctn_1 = [max(a[11:25]), 1 - max]     -> (B, N, 2)
      intrctn_2 = a[11:14] ++ max(a[14:25])    -> (B, N, 4)
      intrctn_3 = a[14:20] ++ max(a[20:25])    -> (B, N, 7)
      intrctn_4 = a[20:25]                     -> (B, N, 5)
    """
    a = actions
    vm = valid[..., None].to(a.dtype)

    def mx(lo, hi):
        return torch.amax(a[..., lo:hi], dim=-1, keepdim=True)

    any_int = mx(11, 25)
    return (torch.cat([a[..., 0:3], mx(3, 10)], dim=-1) * vm,
            torch.cat([a[..., 3:6], mx(6, 10)], dim=-1) * vm,
            a[..., 6:10] * vm,
            torch.cat([any_int, 1.0 - any_int], dim=-1) * vm,
            torch.cat([a[..., 11:14], mx(14, 25)], dim=-1) * vm,
            torch.cat([a[..., 14:20], mx(20, 25)], dim=-1) * vm,
            a[..., 20:25] * vm)
