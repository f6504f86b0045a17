"""KITTI-like LiDAR frames made from a seed, for the Car-only detectors:
a front-facing sweep over KITTI's crop (0, -40, -3, 70.4, 40, 1) m with
its labelled cars.

A mix file (traffic/mixes/<name>.json) gives the parameters; ``frame(p,
seed, index, pool)`` makes frame ``index`` of a pool: the same (seed,
index) gives the same frame. A frame has what a 64-beam scanner 1.73 m
above the road sees in the camera's 90-degree field of view: the ground,
denser near the sensor (a density that falls with the square of the range,
as a spinning scanner's rings do), cars as points on their box surfaces,
more for near cars, and clutter (building fronts along the road, trees
and poles). Each point carries x, y, z and an intensity, and the points
come in a random order, as OpenPCDet's ``shuffle_points`` leaves them for
training. Cars stand on the ground at any heading, apart from each other;
their number is a ladder over the pool (``jrdb_clips.ladder``'s rule), so
every seed's pool holds the same counts.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

LIDAR_HEIGHT = 1.73           # KITTI's scanner above the road, metres
CAR = (3.9, 1.6, 1.56)        # the mean KITTI car, OpenPCDet's anchor


def ladder(lo: int, hi: int, seed: int, index: int, pool: int,
           salt: int) -> int:
    """Entry ``index`` of the counts lo..hi spread evenly over the pool, in
    an order drawn from the seed."""
    counts = np.round(np.linspace(lo, hi, pool)).astype(int)
    order = np.random.default_rng([int(seed) % (2 ** 63), salt]).permutation(
        pool)
    return int(counts[order[index % pool]])


def _in_view(x: np.ndarray, y: np.ndarray, p: dict) -> np.ndarray:
    r = p["range"]
    half = math.radians(p["fov_deg"]) / 2
    return (x > r[0]) & (x < r[3]) & (y > r[1]) & (y < r[4]) \
        & (np.abs(np.arctan2(y, x)) < half)


def _cars(p: dict, rng, n: int) -> np.ndarray:
    """(n, 7) car boxes on the ground in view, centres at least
    ``car_gap_m`` apart."""
    boxes = []
    lo, hi = p["car_range_m"]
    while len(boxes) < n:
        r = rng.uniform(lo, hi)
        az = rng.uniform(-1, 1) * math.radians(p["fov_deg"]) / 2 * 0.9
        x, y = r * math.cos(az), r * math.sin(az)
        if abs(y) > p["range"][4] - 3 or any(
                math.hypot(x - b[0], y - b[1]) < p["car_gap_m"]
                for b in boxes):
            continue
        size = np.asarray(CAR) * rng.uniform(0.9, 1.1, 3)
        boxes.append([x, y, -LIDAR_HEIGHT + size[2] / 2, *size,
                      rng.uniform(-math.pi, math.pi)])
    return np.asarray(boxes, np.float32).reshape(-1, 7)


def _surface(rng, box, k: int) -> np.ndarray:
    """``k`` points on the faces of (cx, cy, cz, dx, dy, dz, yaw)."""
    local = rng.uniform(-0.5, 0.5, (k, 3))
    face = rng.integers(0, 3, k)
    local[np.arange(k), face] = np.sign(local[np.arange(k), face]) * 0.5
    local *= box[3:6]
    c, s = math.cos(box[6]), math.sin(box[6])
    return np.stack([local[:, 0] * c - local[:, 1] * s + box[0],
                     local[:, 0] * s + local[:, 1] * c + box[1],
                     local[:, 2] + box[2]], 1)


def _clutter(p: dict, rng) -> np.ndarray:
    """Building fronts along both sides of the road, and trees and poles
    as narrow vertical clusters."""
    k = p["clutter_points"]
    walls = []
    for side in (-1, 1):
        y0 = side * rng.uniform(*p["wall_offset_m"])
        m = k // 4
        x = rng.uniform(p["range"][0] + 2, p["range"][3], m)
        walls.append(np.stack([x, y0 + rng.normal(0, 0.05, m),
                               rng.uniform(-LIDAR_HEIGHT, 0.9, m)], 1))
    m = k - 2 * (k // 4)
    n_obj = int(rng.integers(*p["trees"]))
    centre = np.stack([rng.uniform(5, p["range"][3], n_obj),
                       rng.uniform(p["range"][1], p["range"][4], n_obj)], 1)
    which = rng.integers(0, n_obj, m)
    spread = rng.uniform(0.1, 0.8, n_obj)[which, None]
    xy = centre[which] + rng.normal(0, 1, (m, 2)) * spread
    z = rng.uniform(-LIDAR_HEIGHT, 0.9, (m, 1))
    return np.concatenate(walls + [np.concatenate([xy, z], 1)])


def frame(p: dict, seed: int, index: int, pool: int) -> Dict[str, np.ndarray]:
    """Frame ``index``: {"points" (N, 4) float32 in view, "gt_boxes" (G, 7)
    float32, "gt_classes" (G,) int32, all 1 (Car)}."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), index, 29])
    n_cars = ladder(*p["cars"], seed, index, pool, 31)
    boxes = _cars(p, rng, n_cars)
    parts = []
    for b in boxes:
        dist = max(math.hypot(b[0], b[1]), 5.0)
        k = int(np.clip(p["car_points_at_10m"] * (10.0 / dist) ** 2,
                        p["car_points_min"], p["car_points_at_10m"]))
        parts.append(_surface(rng, b, k))
    parts.append(_clutter(p, rng))
    pts = np.concatenate(parts)
    pts = pts[_in_view(pts[:, 0], pts[:, 1], p)]
    # the ground fills the frame up to ``points``: ranges log-uniform, so
    # the density falls with the square of the range
    need = max(p["points"] - len(pts), 0)
    ground = np.zeros((0, 3))
    while len(ground) < need:
        m = 2 * (need - len(ground))
        r = 3.0 * (p["range"][3] * 1.2 / 3.0) ** rng.uniform(0, 1, m)
        az = rng.uniform(-1, 1, m) * math.radians(p["fov_deg"]) / 2
        g = np.stack([r * np.cos(az), r * np.sin(az),
                      -LIDAR_HEIGHT + rng.normal(0, 0.03, m)], 1)
        ground = np.concatenate([ground, g[_in_view(g[:, 0], g[:, 1], p)]])
    pts = np.concatenate([pts, ground[:need]])
    pts = np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))], 1)
    pts = pts[rng.permutation(len(pts))].astype(np.float32)
    return {"points": pts, "gt_boxes": boxes,
            "gt_classes": np.ones(len(boxes), np.int32)}
