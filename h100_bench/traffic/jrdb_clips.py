"""JRDB-like clips made from a seed: the panorama frames, the actors with
their 2D and 3D boxes, labels, and a 360-degree LiDAR sweep of a scene.

A mix file (traffic/mixes/<name>.json) gives the parameters; ``clip(p,
seed, index, cfg, pool)`` makes clip ``index`` of a pool: the same (seed,
index) gives the same clip. The sweep has what a robot's two 16-beam scanners see
indoors and on campus: rings on the ground plane, dense near the sensor,
walls, and points on each actor's 3D box surface, more for near actors.
A sweep of uniformly scattered points, as the port's synthetic batch has,
leaves the sparse convs' maps nearly empty; this one has the clustered
neighbourhoods of a real sweep.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

SENSOR_HEIGHT = 1.0           # the scanners above the ground, metres


def _box_surface(rng, box, k: int) -> np.ndarray:
    """``k`` points on the faces of (cx, cy, cz, dx, dy, dz, yaw)."""
    local = rng.uniform(-0.5, 0.5, (k, 3))
    face = rng.integers(0, 3, k)
    local[np.arange(k), face] = np.sign(local[np.arange(k), face]) * 0.5
    local *= box[3:6]
    c, s = math.cos(box[6]), math.sin(box[6])
    return np.stack([local[:, 0] * c - local[:, 1] * s + box[0],
                     local[:, 0] * s + local[:, 1] * c + box[1],
                     local[:, 2] + box[2]], 1)


def ladder(lo: int, hi: int, seed: int, index: int, pool: int,
           salt: int) -> int:
    """Entry ``index`` of the counts lo..hi spread evenly over the pool, in
    an order drawn from the seed: every seed's pool holds the same counts,
    so the seed changes the order of the work and not its amount."""
    counts = np.round(np.linspace(lo, hi, pool)).astype(int)
    order = np.random.default_rng([int(seed) % (2 ** 63), salt]).permutation(
        pool)
    return int(counts[order[index % pool]])


def _actors(p: dict, rng, n_slots: int, n: int):
    """(boxes3d (N, 7), valid (N,), group ids (N,)): ``n`` actors standing
    in groups of 1-4 around group centres."""
    boxes = np.zeros((n_slots, 7), np.float32)
    gid = np.full((n_slots,), -1, np.int32)
    r_lo, r_hi = p["actor_radius_m"]
    i, g = 0, 0
    while i < n:
        members = min(int(rng.integers(1, 5)), n - i)
        r = rng.uniform(r_lo, r_hi)
        az = rng.uniform(-math.pi, math.pi)
        centre = np.array([r * math.cos(az), r * math.sin(az)])
        for _ in range(members):
            size = np.array([0.6, 0.6, 1.7]) * rng.uniform(0.85, 1.15, 3)
            xy = centre + rng.normal(0.0, 0.6, 2)
            boxes[i] = [xy[0], xy[1], -SENSOR_HEIGHT + size[2] / 2,
                        size[0], size[1], size[2], rng.uniform(-math.pi,
                                                               math.pi)]
            gid[i] = g
            i += 1
        g += 1
    valid = np.zeros((n_slots,), bool)
    valid[:n] = True
    return boxes, valid, gid


def _boxes2d(boxes3d, valid, hw) -> np.ndarray:
    """Each actor's box in the 360-degree panorama: the column from the
    azimuth, the rows from the elevation of its top and bottom over a
    60-degree vertical field of view."""
    h, w = hw
    out = np.zeros((len(boxes3d), 4), np.float32)
    for i in np.flatnonzero(valid):
        cx, cy, cz, dx, dy, dz, _ = boxes3d[i]
        r = max(math.hypot(cx, cy), 0.5)
        col = (math.atan2(cy, cx) + math.pi) / (2 * math.pi) * w
        half_w = max(max(dx, dy) / (2 * math.pi * r) * w / 2, 4.0)
        top = math.atan2(cz + dz / 2, r)
        bottom = math.atan2(cz - dz / 2, r)
        fov = math.radians(60.0)
        r0 = (0.5 - top / fov) * h
        r1 = (0.5 - bottom / fov) * h
        x0 = min(max(col - half_w, 0.0), w - 9.0)
        x1 = min(max(col + half_w, x0 + 8.0), w - 1.0)
        y0 = min(max(r0, 0.0), h - 9.0)
        y1 = min(max(r1, y0 + 8.0), h - 1.0)
        out[i] = [x0, y0, x1, y1]
    return out


def _sweep(p: dict, rng, boxes3d, valid, n_walls: int) -> np.ndarray:
    """(num_points, 4) x, y, z, intensity: ground rings, ``n_walls`` walls,
    actors."""
    pts = []
    rings = p["ground_rings"]
    for k in range(rings):
        r = p["ring_start_m"] * p["ring_step"] ** k
        az = rng.uniform(-math.pi, math.pi, p["ring_points"])
        rr = r + rng.normal(0.0, 0.02, len(az))
        z = -SENSOR_HEIGHT + rng.normal(0.0, 0.02, len(az))
        pts.append(np.stack([rr * np.cos(az), rr * np.sin(az), z], 1))
    per_wall = p["wall_points"] // max(n_walls, 1)
    for _ in range(n_walls):
        d = rng.uniform(*p["wall_distance_m"])
        az = rng.uniform(-math.pi, math.pi)
        length = rng.uniform(*p["wall_length_m"])
        t = rng.uniform(-length / 2, length / 2, per_wall)
        # the scanners' beams cross a wall in rows of points
        rows = rng.integers(0, p["wall_rows"], per_wall)
        z = -SENSOR_HEIGHT + rows * (p["wall_height_m"] / p["wall_rows"]) \
            + rng.normal(0.0, 0.02, per_wall)
        nx, ny = math.cos(az), math.sin(az)
        pts.append(np.stack([d * nx - t * ny, d * ny + t * nx, z], 1))
    fixed = sum(len(q) for q in pts)
    left = max(p["points"] - fixed, 0)
    idx = np.flatnonzero(valid)
    if len(idx) and left:
        r = np.maximum(np.hypot(boxes3d[idx, 0], boxes3d[idx, 1]), 1.0)
        share = (1.0 / r ** 2) / np.sum(1.0 / r ** 2)
        counts = np.maximum((share * left).astype(int), p["min_actor_points"])
        for i, k in zip(idx, counts):
            pts.append(_box_surface(rng, boxes3d[i], int(k)))
    xyz = np.concatenate(pts)
    xyz = xyz[rng.permutation(len(xyz))][:p["points"]]
    inten = rng.uniform(0.0, 1.0, (len(xyz), 1))
    return np.concatenate([xyz, inten], 1).astype(np.float32)


def clip(p: dict, seed: int, index: int, cfg: dict,
         pool: int) -> Dict[str, np.ndarray]:
    """Clip ``index`` of a pool of ``pool`` clips drawn from ``seed``: the
    host fields (points, boxes, valid, labels); the frames are made on the
    device by :func:`frames`. ``cfg``: the configuration's sizes
    (``num_boxes``, ``image_size``, ``num_actions``). The counts of actors
    and walls are ladders over the pool (:func:`ladder`)."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), int(index), 11])
    n = cfg["num_boxes"]
    actors = ladder(*p["actors"], seed, index, pool, 1)
    walls = ladder(*p["walls"], seed, index, pool, 2)
    boxes3d, valid, gid = _actors(p, rng, n, actors)
    boxes2d = _boxes2d(boxes3d, valid, cfg["image_size"])
    a = cfg["num_actions"]
    actions = (rng.uniform(size=(n, a)) < p["label_rate"]).astype(np.float32)
    actions[~valid] = 0.0
    group_act = (rng.uniform(size=(n, a)) < p["label_rate"]).astype(
        np.float32)
    for g in np.unique(gid[valid]):
        group_act[gid == g] = group_act[np.flatnonzero(gid == g)[0]]
    group_act[~valid] = 0.0
    return {"points": _sweep(p, rng, boxes3d, valid, walls),
            "boxes2d": boxes2d,
            "boxes3d": boxes3d, "person_valid": valid,
            "social_group_id": gid, "actions": actions,
            "social_group_activity": group_act}


def frames(p: dict, seed: int, index: int, cfg: dict,
           device) -> torch.Tensor:
    """(T, H, W, 3) float32 frames of clip ``index``, made on ``device``:
    squares of ``image_block`` pixels of N(0, 1) values, the panorama's
    coarse structure (white noise would leave the frozen I3D's deep maps
    nearly constant)."""
    t = cfg["num_frames"]
    h, w = cfg["image_size"]
    blk = p["image_block"]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(index) * 7919 + 5)
                    % (2 ** 63))
    small = torch.randn((t, -(-h // blk), -(-w // blk), 3), generator=gen,
                        device=device)
    big = small.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    return big[:, :h, :w].contiguous()
