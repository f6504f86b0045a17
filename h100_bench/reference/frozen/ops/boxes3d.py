"""Rotated 3D box geometry (ops/boxes3d.py) as the plain reference runs it:
corners, rotated BEV / 3D IoU, the nearest-BEV IoU of the anchor assigner,
and the greedy rotated-BEV NMS in its plainest form.

Departures from the port: ``nms_bev`` takes no kernel and packs no words.
It computes the IoU of each box with every box after it in descending
score order, in blocks of ``ROW_BLOCK`` rows (so that 9000 proposals fit),
each pair the later box clipped by the earlier one's edges as the port
does, and sweeps the boxes one by one on the host: box i is kept iff it is
valid and no kept box before it overlaps it above the threshold. pcdet's
``nms_gpu`` computes the overlap by another clip (intersection points and
a sorted hull); both are the exact area up to rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

# rows of the IoU computed at once: 256 x 9000 pairs, a few hundred MB of
# clip buffers
ROW_BLOCK = 256


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



def nms_bev(boxes: torch.Tensor, scores: torch.Tensor,
            iou_threshold: float = 0.7,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy rotated-BEV NMS -> (N,) keep mask, in descending score order
    (a stable sort)."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    order = torch.argsort(-scores, stable=True)
    s = boxes[order]
    over = np.zeros((n, n), bool)          # [i, j]: j > i overlaps i
    for r in range(0, n, ROW_BLOCK):
        iou = boxes_iou_bev(s[r:], s[r:r + ROW_BLOCK]).T     # j clipped by i
        later = torch.arange(r, n, device=boxes.device)[None] \
            > torch.arange(r, min(r + ROW_BLOCK, n),
                           device=boxes.device)[:, None]
        hit = (iou > iou_threshold) & later
        over[r:r + ROW_BLOCK, r:] = hit.cpu().numpy()
    ok = valid[order].cpu().numpy()
    keep = np.zeros(n, bool)
    removed = np.zeros(n, bool)
    for i in range(n):
        if ok[i] and not removed[i]:
            keep[i] = True
            removed |= over[i]
    out = torch.zeros(n, dtype=torch.bool)
    out[order.cpu()] = torch.from_numpy(keep)
    return out.to(boxes.device)
