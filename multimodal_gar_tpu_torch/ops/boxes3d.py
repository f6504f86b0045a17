"""Rotated 3D box geometry: corners, containment, BEV / 3D IoU and NMS
(ops/boxes3d.py: the detectors' part of it).

Box layout: (cx, cy, cz, dx, dy, dz, yaw), centre + full extents +
z-rotation. The rotated BEV overlap clips one rectangle by the other's four
edges (Sutherland-Hodgman) in a fixed 8-vertex buffer per pair, batched over
every pair at once. The greedy NMS sweeps run on the boxes' device without a
host round trip per box (``_greedy_sweep``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import math

import torch

_VBUF = 8  # max vertices of a rect-rect intersection

_CORNER_SIGNS = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
                 (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))
_BEV_SIGNS = ((1, 1), (-1, 1), (-1, -1), (1, -1))


def boxes_to_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 8, 3) corners (pcdet box_utils.boxes_to_corners_3d)."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=boxes.dtype,
                         device=boxes.device)
    local = signs[None] * boxes[:, None, 3:6] / 2.0
    c, s = torch.cos(boxes[:, 6])[:, None], torch.sin(boxes[:, 6])[:, None]
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return torch.stack([x, y, local[..., 2]], dim=-1) + boxes[:, None, 0:3]


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(P, 3) x (N, 7) -> (P, N) bool containment."""
    rel = points[:, None, :3] - boxes[None, :, 0:3]
    c, s = torch.cos(-boxes[:, 6])[None], torch.sin(-boxes[:, 6])[None]
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    half = boxes[None, :, 3:6] / 2.0
    return ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
            & (rel[..., 2].abs() <= half[..., 2]))


def _bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 4, 2) BEV corners, counter-clockwise."""
    signs = torch.tensor(_BEV_SIGNS, dtype=boxes.dtype, device=boxes.device)
    local = signs * boxes[..., None, 3:5] / 2.0
    c, s = torch.cos(boxes[..., 6:7]), torch.sin(boxes[..., 6:7])
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return torch.stack([x + boxes[..., None, 0], y + boxes[..., None, 1]],
                       dim=-1)


def _next_vertex(poly: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """poly (P, K, 2) -> the vertex after each one, cycling at ``count``."""
    k = poly.shape[1]
    idx = torch.arange(k, device=poly.device)
    nxt = (idx[None] + 1) % count.clamp(min=1)[:, None]            # (P, K)
    return torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))


def _clip_halfplane(poly, count, p1, p2):
    """Clip each (K, 2) / count polygon of (P, K, 2) by the half-plane left
    of p1 -> p2 (P, 2) (``_clip_halfplane``)."""
    p, k = poly.shape[:2]
    idx = torch.arange(k, device=poly.device)
    nxt = _next_vertex(poly, count)
    edge = (p2 - p1)[:, None]
    s_cur = edge[..., 0] * (poly[..., 1] - p1[:, None, 1]) \
        - edge[..., 1] * (poly[..., 0] - p1[:, None, 0])
    s_nxt = edge[..., 0] * (nxt[..., 1] - p1[:, None, 1]) \
        - edge[..., 1] * (nxt[..., 0] - p1[:, None, 0])
    in_cur, in_nxt = s_cur >= 0, s_nxt >= 0
    active = idx[None] < count[:, None]
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
    inter = poly + t[..., None] * (nxt - poly)
    # per input edge: the current vertex (inside), the crossing (if any)
    pts = torch.stack([poly, inter], dim=2).reshape(p, 2 * k, 2)
    val = torch.stack([active & in_cur, active & (in_cur != in_nxt)],
                      dim=2).reshape(p, 2 * k)
    # the running count as a product with a triangular matrix: exact for
    # these small integers, and one GEMM where a scan over 2K-long rows
    # of a million pairs takes the card milliseconds
    tri = torch.ones((2 * k, 2 * k), dtype=poly.dtype,
                     device=poly.device).triu()
    pos = (val.to(poly.dtype) @ tri).to(torch.int64) - 1
    target = torch.where(val & (pos < k), pos, k)
    out = torch.zeros((p, k + 1, 2), dtype=poly.dtype, device=poly.device)
    out.scatter_(1, target[..., None].expand(-1, -1, 2), pts)
    return out[:, :k], val.sum(dim=1)


def _poly_area(poly, count):
    k = poly.shape[1]
    idx = torch.arange(k, device=poly.device)
    nxt = _next_vertex(poly, count)
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    cross = torch.where(idx[None] < count[:, None], cross,
                        torch.zeros_like(cross))
    return cross.sum(dim=1).abs() / 2.0


def boxes_overlap_bev(boxes_a: torch.Tensor,
                      boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) rotated BEV intersection areas."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    ca = _bev_corners(boxes_a)[:, None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    cb = _bev_corners(boxes_b)[None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    poly = torch.zeros((n * m, _VBUF, 2), dtype=boxes_a.dtype,
                       device=boxes_a.device)
    poly[:, :4] = ca
    count = torch.full((n * m,), 4, dtype=torch.int64, device=boxes_a.device)
    for i in range(4):
        poly, count = _clip_halfplane(poly, count, cb[:, i],
                                      cb[:, (i + 1) % 4])
    return _poly_area(poly, count).reshape(n, m)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                  ) -> torch.Tensor:
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) 3D IoU."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    zo = (torch.minimum(za2[:, None], zb2[None, :])
          - torch.maximum(za1[:, None], zb1[None, :])).clamp(min=0.0)
    inter = inter_bev * zo
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return inter / (vol_a[:, None] + vol_b[None, :] - inter).clamp(min=1e-9)


# the sweep reads its convergence flag on the host once every this many
# rounds (each read is a device sync)
SWEEP_CHECK_EVERY = 4


def _greedy_sweep(suppress: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask of ``nms_bev``'s sequential sweep.

    In descending score order (a stable sort, as ``jnp.argsort(-scores)``),
    box i is kept iff it is valid and no kept box before it suppresses it:
    ``keep[i] = valid[i] & ~any_{j<i}(keep[j] & suppress[i, j])`` with
    ``suppress`` in sorted order. That recurrence has one solution, and the
    iteration ``keep <- valid & ~any(keep & S)`` from ``keep = valid``
    fixes one more leading box each round and stops changing once it is
    there, after as many rounds as the longest chain of boxes whose fate
    hangs on the one before (at most N). Each round is one masked
    matrix-vector product on the device; the host reads one flag every
    ``SWEEP_CHECK_EVERY`` rounds.
    """
    n = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    s = suppress[order][:, order]
    s = torch.tril(s, diagonal=-1).to(torch.float32)       # j < i only
    valid_s = valid[order]
    keep = valid_s.clone()
    for r in range(n):
        new = valid_s & ~((s @ keep.to(torch.float32)) > 0)
        done = (r + 1) % SWEEP_CHECK_EVERY == 0 or r == n - 1
        if done and torch.equal(new, keep):
            keep = new
            break
        keep = new
    out = torch.zeros_like(keep)
    out[order] = keep
    return out


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor,
            iou_threshold: float = 0.7,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy rotated-BEV NMS -> (N,) keep mask: the IoU matrix, then the
    sweep in descending score order."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    if n == 0:
        return valid
    iou = boxes_iou_bev(boxes, boxes)
    return _greedy_sweep(iou > iou_threshold, scores, valid)


def nms_normal_bev(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float = 0.7,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Axis-aligned (yaw 0) variant."""
    aa = boxes.clone()
    aa[:, 6] = 0.0
    return nms_bev(aa, scores, iou_threshold, valid)


def circle_nms(boxes: torch.Tensor, scores: torch.Tensor,
               dist_threshold: float = 2.0,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy centre-distance NMS -> (N,) keep mask: a lower-scored box is
    suppressed when its squared BEV centre distance to a kept box is <=
    ``dist_threshold`` (the reference compares the squared distance with
    the raw min_radius value)."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    if n == 0:
        return valid
    centers = boxes[:, :2]
    d2 = ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return _greedy_sweep(d2 <= dist_threshold, scores, valid)


def enlarge_box3d(boxes: torch.Tensor,
                  extra_width: Sequence[float] = (0.0, 0.0, 0.0)
                  ) -> torch.Tensor:
    """Grow boxes by extra extents (pcdet box_utils.enlarge_box3d)."""
    extra = torch.tensor(extra_width, dtype=boxes.dtype, device=boxes.device)
    out = boxes.clone()
    out[..., 3:6] = out[..., 3:6] + 2.0 * extra
    return out


def _to_aabb(b: torch.Tensor) -> torch.Tensor:
    yaw = torch.remainder(b[..., 6], math.pi).abs()
    swap = (yaw > math.pi / 4) & (yaw < 3 * math.pi / 4)
    dx = torch.where(swap, b[..., 4], b[..., 3])
    dy = torch.where(swap, b[..., 3], b[..., 4])
    return torch.stack([b[..., 0] - dx / 2, b[..., 1] - dy / 2,
                        b[..., 0] + dx / 2, b[..., 1] + dy / 2], dim=-1)


def boxes3d_nearest_bev_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                            ) -> torch.Tensor:
    """Axis-aligned BEV IoU with the yaw snapped to the nearer right angle
    (pcdet box_utils.boxes3d_nearest_bev_iou). (..., N, 7) x (..., M, 7)
    -> (..., N, M)."""
    a = _to_aabb(boxes_a)[..., :, None, :]
    b = _to_aabb(boxes_b)[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter).clamp(min=1e-9)
