"""The benchmark's copy of the port's host voxelizer (data/voxelizer.py),
numpy only: the benchmark voxelizes its own points and hands the same
voxels to the program and to the reference.

Deterministic host-side point-cloud voxelizer (numpy, vectorized).

Capability parity with spconv's Point2VoxelCPU3d as wrapped by the reference
(pcdet/datasets/processor/data_processor.py:15-60): first-come voxel ordering,
per-voxel point cap, max-voxel cap, zyx coordinate output — re-implemented
from the documented semantics (no spconv dependency). The port's C++ fast path is
left out.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np


class VoxelizerOutput(NamedTuple):
    voxels: np.ndarray        # (M, P, C) per-voxel raw points, zero padded
    coords: np.ndarray        # (M, 3) int32 zyx
    num_points: np.ndarray    # (M,) int32


class Voxelizer:
    def __init__(self, voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float],
                 max_points_per_voxel: int, max_voxels: int):
        self.voxel_size = np.asarray(voxel_size, np.float64)
        self.range = np.asarray(point_cloud_range, np.float64)
        self.max_points = max_points_per_voxel
        self.max_voxels = max_voxels
        self.grid_size = np.round(
            (self.range[3:6] - self.range[0:3]) / self.voxel_size).astype(np.int64)

    def __call__(self, points: np.ndarray) -> VoxelizerOutput:
        """Voxelize (N, C) points (first 3 columns = xyz).

        Points are processed in input order: the k-th distinct voxel to appear
        gets index k; each voxel keeps its first ``max_points`` points; voxels
        beyond ``max_voxels`` are dropped (with all their points).
        """
        c = points.shape[1]
        coords = np.floor(
            (points[:, :3] - self.range[:3]) / self.voxel_size).astype(np.int64)
        in_range = np.all((coords >= 0) & (coords < self.grid_size), axis=1)
        pts = points[in_range]
        coords = coords[in_range]

        if len(pts) == 0:
            return VoxelizerOutput(
                np.zeros((0, self.max_points, c), points.dtype),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))

        # linear voxel key (xyz order for the key; output coords are zyx)
        key = (coords[:, 2] * self.grid_size[1] + coords[:, 1]) \
            * self.grid_size[0] + coords[:, 0]

        # first-occurrence voxel ordering
        _, first_idx, inverse = np.unique(key, return_index=True,
                                          return_inverse=True)
        order_of_voxel = np.argsort(np.argsort(first_idx))  # sorted-unique -> appearance rank
        voxel_id = order_of_voxel[inverse]                  # per-point voxel id

        n_voxels = min(len(first_idx), self.max_voxels)

        # stable sort points by voxel id to group them, preserving point order
        perm = np.argsort(voxel_id, kind="stable")
        sorted_vid = voxel_id[perm]
        # position of each point within its voxel
        starts = np.searchsorted(sorted_vid, np.arange(len(first_idx)))
        within = np.arange(len(sorted_vid)) - starts[sorted_vid]

        keep = (sorted_vid < n_voxels) & (within < self.max_points)
        vid_k = sorted_vid[keep]
        within_k = within[keep]
        pts_k = pts[perm[keep]]

        voxels = np.zeros((n_voxels, self.max_points, c), points.dtype)
        voxels[vid_k, within_k] = pts_k
        num_points = np.bincount(vid_k, minlength=n_voxels).astype(np.int32)

        # coords of voxel k in appearance order, zyx
        first_occurrence = np.zeros(len(first_idx), np.int64)
        first_occurrence[order_of_voxel] = first_idx
        vc = coords[first_occurrence[:n_voxels]]
        out_coords = vc[:, ::-1].astype(np.int32)           # xyz -> zyx
        return VoxelizerOutput(voxels, out_coords, num_points)


def pad_voxels(out: VoxelizerOutput, max_voxels: int, num_features: int,
               max_points: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a VoxelizerOutput to fixed (max_voxels, ...) arrays + validity mask."""
    m = out.voxels.shape[0]
    voxels = np.zeros((max_voxels, max_points, num_features), np.float32)
    coords = np.full((max_voxels, 3), -1, np.int32)
    nump = np.zeros((max_voxels,), np.int32)
    valid = np.zeros((max_voxels,), bool)
    k = min(m, max_voxels)
    voxels[:k] = out.voxels[:k]
    coords[:k] = out.coords[:k]
    nump[:k] = out.num_points[:k]
    valid[:k] = True
    return voxels, coords, nump, valid
