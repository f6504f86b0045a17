"""Rotated 3D box geometry: corners, containment, BEV / 3D IoU and NMS
(ops/boxes3d.py: the detectors' part of it).

Box layout: (cx, cy, cz, dx, dy, dz, yaw), centre + full extents +
z-rotation. The rotated BEV overlap clips one rectangle by the other's four
edges (Sutherland-Hodgman) in a fixed 8-vertex buffer per pair, batched over
every pair at once. The greedy NMS never builds the N x N matrix: it packs
the suppression relation into 64-bit words and sweeps them
(ops/kernels/nms_bev.py: kernels on the card, no host round trip; the same
words in blocks of rows and a loop on the CPU).
"""
from __future__ import annotations

from typing import Optional, Sequence

import math

import torch

from ..utils import profiling
from .kernels import nms_bev as nms_words

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
    """(..., P, 3) x (..., N, 7) -> (..., P, N) bool containment."""
    rel = points[..., :, None, :3] - boxes[..., None, :, 0:3]
    c = torch.cos(-boxes[..., 6])[..., None, :]
    s = torch.sin(-boxes[..., 6])[..., None, :]
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    half = boxes[..., None, :, 3:6] / 2.0
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


def _pair_overlap_bev(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(P, 4, 2) x (P, 4, 2) BEV corners -> (P,) intersection areas: each
    rectangle of ``ca`` clipped by the edges of its pair in ``cb``."""
    p = ca.shape[0]
    poly = torch.zeros((p, _VBUF, 2), dtype=ca.dtype, device=ca.device)
    poly[:, :4] = ca
    count = torch.full((p,), 4, dtype=torch.int64, device=ca.device)
    for i in range(4):
        poly, count = _clip_halfplane(poly, count, cb[:, i],
                                      cb[:, (i + 1) % 4])
    return _poly_area(poly, count)


def boxes_overlap_bev(boxes_a: torch.Tensor,
                      boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) rotated BEV intersection areas."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    ca = _bev_corners(boxes_a)[:, None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    cb = _bev_corners(boxes_b)[None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    return _pair_overlap_bev(ca, cb).reshape(n, m)


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


def _sweep_sorted(words: torch.Tensor, order: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The keep mask in the boxes' own order from the words of the boxes
    in ``order``."""
    keep_sorted = nms_words.sweep(words, valid[order])
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor,
            iou_threshold: float = 0.7,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy rotated-BEV NMS -> (N,) keep mask.

    In descending score order (a stable sort, as ``jnp.argsort(-scores)``),
    box i is kept iff it is valid and no kept box before it has a BEV IoU
    above ``iou_threshold`` with it, the later box's rectangle clipped by
    the earlier one's edges. The relation is packed into words
    (ops/kernels/nms_bev.py), (N, ceil(N / 64)) int64, and swept; nothing
    synchronises with the host. While a profiler records, the counters
    ``nms.boxes_in``, ``nms.boxes_kept``, ``nms.clip_pairs`` (pairs that
    reached the exact clip) and ``nms.overlap_pairs`` (pairs whose
    rectangles overlap) add this call's numbers."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    if n == 0:
        return valid
    order = torch.argsort(-scores, stable=True)
    words, counters = nms_words.bev_words(boxes[order], iou_threshold)
    keep = _sweep_sorted(words, order, valid)
    if profiling.recording():
        profiling.count("nms.boxes_in", valid.sum())
        profiling.count("nms.boxes_kept", keep.sum())
        profiling.count("nms.clip_pairs", counters[0])
        profiling.count("nms.overlap_pairs", counters[1])
    return keep


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
    order = torch.argsort(-scores, stable=True)
    centers = boxes[order, :2]
    later = torch.arange(n, device=boxes.device)
    block = nms_words.BLOCK
    words = torch.cat([nms_words.pack_words(
        (((centers[None, :] - centers[s:s + block, None]) ** 2).sum(-1)
         <= dist_threshold) & (later[None, :] > later[s:s + block, None]))
        for s in range(0, n, block)])
    return _sweep_sorted(words, order, valid)


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


# ---------------------------------------------------------------------------
# RoI-aware and RoI-point pooling
# ---------------------------------------------------------------------------

def roiaware_pool3d(points: torch.Tensor, features: torch.Tensor,
                    boxes: torch.Tensor, out_size: int = 6,
                    pool_method: str = "max") -> torch.Tensor:
    """Point features pooled into a (G, G, G) grid per box
    (roiaware_pool3d_kernel.cu): each in-box point lands in the cell of
    its box-local coordinates; a cell takes the max (``"max"``) or the
    mean (``"avg"``) of its points, 0 where it has none.

    points (..., P, 3), features (..., P, C), boxes (..., N, 7) ->
    (..., N, G, G, G, C), batched over the leading dimensions. Only the
    (box, point) pairs inside are gathered: max is a ``scatter_reduce``
    "amax" into a -inf buffer with the non-finite cells zeroed (its
    gradient goes to the cell's maximum), avg a sum and a count.
    """
    lead = boxes.shape[:-2]
    nb, p, c = boxes.shape[-2], points.shape[-2], features.shape[-1]
    g3 = out_size ** 3
    pts = points.reshape(-1, p, 3)
    feats = features.reshape(-1, p, c)
    bx = boxes.reshape(-1, nb, 7)
    b = bx.shape[0]
    with torch.no_grad():
        rel = pts[:, None, :, :] - bx[:, :, None, 0:3]          # (B, N, P, 3)
        cs = torch.cos(-bx[..., 6])[..., None]
        sn = torch.sin(-bx[..., 6])[..., None]
        local = torch.stack([rel[..., 0] * cs - rel[..., 1] * sn,
                             rel[..., 0] * sn + rel[..., 1] * cs,
                             rel[..., 2]], dim=-1)
        half = bx[:, :, None, 3:6] / 2.0
        inside = (local.abs() <= half).all(-1)
        # zero-extent (padded) boxes: a 0 cell would make NaN cells
        cell_size = torch.clamp(2 * half / out_size, min=1e-6)
        cell = torch.clamp(torch.floor((local + half) / cell_size), 0,
                           out_size - 1).long()
        flat = (cell[..., 0] * out_size + cell[..., 1]) * out_size \
            + cell[..., 2]
        bi, ni, pi = inside.nonzero(as_tuple=True)
        row = (bi * nb + ni) * g3 + flat[bi, ni, pi]
    src = feats[bi, pi]                                         # (pairs, C)
    if pool_method == "max":
        grid = torch.full((b * nb * g3, c), -torch.inf, dtype=src.dtype,
                          device=src.device).scatter_reduce(
            0, row[:, None].expand(-1, c), src, "amax", include_self=True)
        grid = torch.where(torch.isfinite(grid), grid, 0.0)
    elif pool_method == "avg":
        num = src.new_zeros((b * nb * g3, c)).index_add_(0, row, src)
        cnt = src.new_zeros((b * nb * g3, 1)).index_add_(
            0, row, torch.ones_like(src[:, :1]))
        grid = num / torch.clamp(cnt, min=1.0)
    else:
        raise ValueError(f"pool_method {pool_method!r}: max or avg")
    return grid.reshape(lead + (nb, out_size, out_size, out_size, c))


def roipoint_pool3d(points: torch.Tensor, features: torch.Tensor,
                    boxes: torch.Tensor, num_sampled_points: int = 512):
    """The first ``num_sampled_points`` in-box points of each box in point
    order with their features (roipoint_pool3d_kernel.cu); slots past a
    box's count cycle through its real points (``slot % cnt``, :94-95),
    since zeros would feed fake origin points to the per-RoI encoder.

    points (..., P, 3), features (..., P, C), boxes (..., N, 7) ->
    (pooled (..., N, K, 3 + C), zeros for a box with no point; empty
    (..., N) bool). The points are selected by their rank among the box's
    hits, so the selection is exact.
    """
    from .neighbor import first_hits
    k = num_sampled_points
    with torch.no_grad():
        inside = points_in_boxes(points, boxes).transpose(-1, -2)  # (.,N,P)
        pos, count = first_hits(inside, k)
        slot = torch.arange(k, device=points.device)
        cyc = slot % torch.clamp(count, min=1)[..., None]
        pos = torch.gather(pos, -1, cyc).clamp(min=0)
        empty = count == 0
    lead = boxes.shape[:-2]
    nb = boxes.shape[-2]
    rows = pos.reshape(lead + (nb * k,))
    from .neighbor import grouping_operation
    pooled = torch.cat([grouping_operation(points[..., :3], rows[..., None]),
                        grouping_operation(features, rows[..., None])],
                       dim=-1).reshape(lead + (nb, k, -1))
    pooled = torch.where(empty[..., None, None], 0.0, pooled)
    return pooled, empty
