"""Explicit (R, 27) index maps of VoxelBackbone8x's sparse convs.

Both directions of the nbr-map path read explicit maps: for each output
row and tap the table row that feeds it (-1 absent). They come from the
device-built ``nbr_k`` / ``down_k`` (ops/device_rulebook.py) and are built
on the device with plain torch ops.

A layer's backward needs both directions:

- ``fwd`` (B, R, 27): table row of each output row's tap; K4 (the weight
  gradient) gathers the layer input through it.
- ``bwd`` (B, M, 27): output row that each table row feeds at each tap; K3
  gathers dOut through it for the data gradient. A submanifold map is its
  own inverse with the taps mirrored (``nbr[i, k] = j`` exactly when
  ``nbr[j, 26 - k] = i``), so ``bwd`` is ``fwd`` and the weights flip. A
  strided map's inverse is ``up[down[o, k], k] = o``: each (input row, tap)
  feeds at most one output, so the scatter has unique keys and is exact.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ConvMaps:
    """The two index maps of one sparse conv layer (int32, -1 absent)."""
    fwd: torch.Tensor          # (B, R, 27) table rows of each output row
    bwd: Optional[torch.Tensor]  # (B, M, 27) output rows of each
    #                              table row (None: forward only)
    mirrored: bool             # submanifold: bwd taps are fwd's, k -> 26 - k

    @functools.cached_property
    def fwd_taps(self) -> torch.Tensor:
        """``fwd``'s tap columns, (27, B R) int32: ``fwd_taps[k, b R + r]
        = fwd[b, r, k]``. Kernel D (the bf16 weight gradient) reads a tap's
        column coalesced from it; made once per map, on first use, and
        shared by every layer on the map."""
        return tap_columns(self.fwd)

    def dgrad_weights(self, weights: torch.Tensor) -> torch.Tensor:
        """(27, C, D) layer weights -> the (27, D, C) weights that map dOut
        through ``bwd`` to d(table)."""
        w = weights.flip(0) if self.mirrored else weights
        return w.transpose(1, 2).contiguous()


def tap_columns(idx: torch.Tensor) -> torch.Tensor:
    """A (B, R, K) map's tap columns, (K, B R), each contiguous."""
    return idx.permute(2, 0, 1).reshape(idx.shape[-1], -1).contiguous()


def gather_taps(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, M, C) rows at idx (B, R, K) -> (B, R, K, C), zeros where
    idx is -1."""
    bidx = torch.arange(table.shape[0], device=table.device)[:, None, None]
    hit = (idx >= 0)[..., None].to(table.dtype)
    return table[bidx, idx.clamp(min=0).long()] * hit


def remap_rows(idx: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Row indices (B, R, K) through a per-item permutation inv (B, M);
    -1 stays -1."""
    bidx = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return torch.where(idx >= 0, inv[bidx, idx.clamp(min=0).long()],
                       -1).to(torch.int32)


def inverse_map(down: torch.Tensor, m_in: int) -> torch.Tensor:
    """``up`` (B, m_in, 27) with up[b, down[b, o, k], k] = o, -1 elsewhere.

    Keys (b, row, k) are unique over the present entries of a strided map,
    so a scatter without accumulation is exact; absent entries all land on
    one spare slot that is dropped.
    """
    b, mo, taps = down.shape
    dev = down.device
    size = b * m_in * taps
    bidx = torch.arange(b, device=dev)[:, None, None]
    kidx = torch.arange(taps, device=dev)[None, None, :]
    target = (bidx * m_in + down.long()) * taps + kidx
    target = torch.where(down >= 0, target, size)
    rows = torch.arange(mo, device=dev, dtype=torch.int32)[None, :, None]
    up = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    up.scatter_(0, target.reshape(-1), rows.expand(b, mo, taps).reshape(-1))
    return up[:size].view(b, m_in, taps)


def backbone_maps(rb: Dict[str, torch.Tensor], key_sorted: bool,
                  with_bwd: bool = True) -> Dict[str, ConvMaps]:
    """ConvMaps of a backbone's submanifold maps (``nbr_0`` .. ``nbr_S``)
    and strided maps (``down_1`` .. ``down_S``), S + 1 stages as the
    rulebook holds (VoxelBackbone8x's 4).

    ``key_sorted``: stage 0 runs in ``order_0``'s key-sorted row order (the
    x-window path), so ``nbr_0`` and ``down_1``, which index the original
    stage-0 rows, are remapped through the inverse permutation. The later
    stages are key-sorted already. Without ``with_bwd`` the strided inverse
    maps are not built (a forward-only nbr-map pass needs only ``fwd``).
    """
    stages = sum(1 for k in rb if k.startswith("nbr_"))
    nbr = {k: rb[f"nbr_{k}"] for k in range(stages)}
    down = {k: rb[f"down_{k}"] for k in range(1, stages)}
    if key_sorted:
        order = rb["order_0"].long()                      # (B, M0)
        inv = torch.empty_like(order)
        inv.scatter_(1, order, torch.arange(order.shape[1],
                                            device=order.device
                                            ).expand_as(order).contiguous())
        rows = torch.gather(nbr[0], 1,
                            order[..., None].expand(-1, -1, 27))
        nbr[0] = remap_rows(rows, inv)
        down[1] = remap_rows(down[1], inv)
    maps = {f"nbr_{k}": ConvMaps(v, v, True) for k, v in nbr.items()}
    for k, v in down.items():
        m_in = nbr[k - 1].shape[1]
        up = inverse_map(v, m_in) if with_bwd else None
        maps[f"down_{k}"] = ConvMaps(v, up, False)
    return maps


