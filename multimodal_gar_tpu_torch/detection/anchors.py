"""Anchor generation for dense detection heads.

Capability parity with the reference's grid anchor generator
(pcdet/models/dense_heads/target_assigner/anchor_generator.py:17-60):
per-class anchor sets over a BEV feature grid, each the cartesian product of
grid centers x anchor sizes x rotations x bottom heights, with the reference's
exact placement rules (align_center on/off, z shifted to box centers).

TPU-native design: anchors are STATIC data — computed once in numpy at model
build time and closed over as constants — so target assignment and box
decoding jit with fixed shapes. Layout per class: (H, W, num_z, num_size,
num_rot, 7) flattened to (H*W*A, 7) in the reference's memory order
(anchors.permute(2,1,0,...) then view(-1) == z-major over (z, y, x, size, rot)
-> our flatten uses the same (z, y, x, size, rot) order after the transpose,
i.e. row index = ((z*H + y)*W + x)*S*R + s*R + r).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorClassConfig:
    """One class's anchor set (reference anchor_generator_config entries)."""
    class_name: str = "Car"
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = ((3.9, 1.6, 1.56),)
    anchor_rotations: Tuple[float, ...] = (0.0, 1.57)
    anchor_bottom_heights: Tuple[float, ...] = (-1.78,)
    align_center: bool = False
    feature_map_stride: int = 8
    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45


def generate_anchors(configs: Sequence[AnchorClassConfig],
                     grid_size: Tuple[int, int],
                     point_cloud_range: Sequence[float]
                     ) -> Tuple[List[np.ndarray], List[int]]:
    """Return ([per-class (H*W*A, 7) float32], [A per location per class]).

    grid_size is the full voxel grid (nx, ny); each class's feature map is
    grid_size // feature_map_stride. Matches anchor_generator.py:25-59:
    stride = range / (fmap - 1) when not align_center (offset 0), else
    range / fmap with half-stride offset; z = bottom height + dz/2.
    """
    pr = np.asarray(point_cloud_range, np.float64)
    all_anchors, num_per_loc = [], []
    for cfg in configs:
        fx = grid_size[0] // cfg.feature_map_stride
        fy = grid_size[1] // cfg.feature_map_stride
        if cfg.align_center:
            x_stride = (pr[3] - pr[0]) / fx
            y_stride = (pr[4] - pr[1]) / fy
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (pr[3] - pr[0]) / (fx - 1)
            y_stride = (pr[4] - pr[1]) / (fy - 1)
            x_off = y_off = 0.0
        # torch.arange(start, end+1e-5, step) semantics
        x_shifts = np.arange(pr[0] + x_off, pr[3] + 1e-5, x_stride)
        y_shifts = np.arange(pr[1] + y_off, pr[4] + 1e-5, y_stride)
        z_shifts = np.asarray(cfg.anchor_bottom_heights, np.float64)
        sizes = np.asarray(cfg.anchor_sizes, np.float64)       # (S, 3) dx,dy,dz
        rots = np.asarray(cfg.anchor_rotations, np.float64)    # (R,)

        nz, ny, nx = len(z_shifts), len(y_shifts), len(x_shifts)
        ns, nr = len(sizes), len(rots)
        # (z, y, x) grid after the reference's permute(2,1,0,...)
        zz, yy, xx = np.meshgrid(z_shifts, y_shifts, x_shifts, indexing="ij")
        centers = np.stack([xx, yy, zz], -1)                    # (nz,ny,nx,3)
        a = np.broadcast_to(centers[:, :, :, None, None, :],
                            (nz, ny, nx, ns, nr, 3))
        s = np.broadcast_to(sizes[None, None, None, :, None, :],
                            (nz, ny, nx, ns, nr, 3))
        r = np.broadcast_to(rots[None, None, None, None, :, None],
                            (nz, ny, nx, ns, nr, 1))
        anchors = np.concatenate([a, s, r], -1).astype(np.float32)
        anchors[..., 2] += anchors[..., 5] / 2                  # bottom -> center
        all_anchors.append(anchors.reshape(-1, 7))
        num_per_loc.append(ns * nr * nz)
    return all_anchors, num_per_loc


# KITTI 3-class defaults (upstream OpenPCDet kitti cfgs; the vendored pcdet in
# the reference ships no YAMLs, so these canonical values define the zoo's
# default working point).
KITTI_CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")
KITTI_ANCHORS = (
    AnchorClassConfig("Car", ((3.9, 1.6, 1.56),), (0.0, 1.57), (-1.78,),
                      False, 8, 0.6, 0.45),
    AnchorClassConfig("Pedestrian", ((0.8, 0.6, 1.73),), (0.0, 1.57), (-0.6,),
                      False, 8, 0.5, 0.35),
    AnchorClassConfig("Cyclist", ((1.76, 0.6, 1.73),), (0.0, 1.57), (-0.6,),
                      False, 8, 0.5, 0.35),
)
KITTI_POINT_CLOUD_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
KITTI_VOXEL_SIZE = (0.05, 0.05, 0.1)          # grid 1408 x 1600 x 40
KITTI_PILLAR_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
KITTI_PILLAR_SIZE = (0.16, 0.16, 4.0)         # grid 432 x 496 x 1
