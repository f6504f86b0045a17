"""Point-cloud processor chain: the configurable host-side transforms.

Capability parity with pcdet's DataProcessor registry
(pcdet/datasets/processor/data_processor.py:63-248): a chain of named,
config-driven numpy transforms. The active mil3.yaml chain is
[mask_points_and_boxes_outside_range, shuffle_points,
transform_points_to_voxels]; the voxelizer lives in data/voxelizer.py.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def mask_points_outside_range(points: np.ndarray,
                              limit_range: Sequence[float]) -> np.ndarray:
    """Keep points whose x/y lie inside the range (z intentionally ignored —
    pcdet common_utils.mask_points_by_range:60 checks only x and y)."""
    m = ((points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
         & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4]))
    return points[m]


def mask_boxes_outside_range(boxes: np.ndarray, limit_range: Sequence[float],
                             min_num_corners: int = 1) -> np.ndarray:
    """Keep boxes with >= min_num_corners BEV corners inside the range
    (pcdet box_utils.mask_boxes_outside_range_numpy:93)."""
    from ..ops.boxes3d import boxes_to_corners_3d
    import torch
    corners = boxes_to_corners_3d(torch.from_numpy(np.asarray(boxes, np.float32))).numpy()
    inside = ((corners[..., 0] >= limit_range[0])
              & (corners[..., 0] <= limit_range[3])
              & (corners[..., 1] >= limit_range[1])
              & (corners[..., 1] <= limit_range[4]))
    return inside.sum(axis=1) >= min_num_corners


def shuffle_points(points: np.ndarray,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    return points[rng.permutation(len(points))]


def sample_points_processor(points: np.ndarray, num_points: int,
                            rng: Optional[np.random.Generator] = None
                            ) -> np.ndarray:
    """Far/near-aware point sampling (data_processor.sample_points:181
    semantics simplified to uniform; JRDB uses the dual-velodyne sampler in
    data/pointcloud.py)."""
    from .pointcloud import sample_points
    return sample_points(points, num_points, rng)


def double_flip(points: np.ndarray):
    """y-flip / x-flip / xy-flip copies (data_processor.double_flip:116),
    used by test-time-augmentation configs."""
    yflip = points.copy()
    yflip[:, 1] = -yflip[:, 1]
    xflip = points.copy()
    xflip[:, 0] = -xflip[:, 0]
    xyflip = points.copy()
    xyflip[:, 0] = -xyflip[:, 0]
    xyflip[:, 1] = -xyflip[:, 1]
    return yflip, xflip, xyflip


def downsample_depth_map(depth_map: np.ndarray, factor: int) -> np.ndarray:
    """Block-mean downscale of a (H, W) depth map
    (data_processor.downsample_depth_map:221-230, which wraps skimage's
    downscale_local_mean — CaDDN's image-branch input prep). Edge blocks are
    zero-padded before averaging, matching downscale_local_mean(cval=0).
    """
    h, w = depth_map.shape[:2]
    hp = -(-h // factor) * factor
    wp = -(-w // factor) * factor
    pad = [(0, hp - h), (0, wp - w)] + [(0, 0)] * (depth_map.ndim - 2)
    x = np.pad(depth_map, pad)
    x = x.reshape((hp // factor, factor, wp // factor, factor)
                  + x.shape[2:])
    return x.mean(axis=(1, 3))


class ProcessorChain:
    """Named-processor chain built from config dicts (DataProcessor parity)."""

    def __init__(self, steps: List[Dict], point_cloud_range: Sequence[float],
                 training: bool, rng: Optional[np.random.Generator] = None):
        self.range = point_cloud_range
        self.training = training
        self.rng = rng or np.random.default_rng(0)
        self.steps = steps

    def __call__(self, points: np.ndarray) -> np.ndarray:
        for step in self.steps:
            name = step["NAME"]
            if name == "mask_points_and_boxes_outside_range":
                points = mask_points_outside_range(points, self.range)
            elif name == "shuffle_points":
                enabled = step.get("SHUFFLE_ENABLED", {}).get(
                    "train" if self.training else "test", self.training)
                if enabled:
                    points = shuffle_points(points, self.rng)
            elif name == "sample_points":
                points = sample_points_processor(
                    points, step["NUM_POINTS"], self.rng)
            elif name == "transform_points_to_voxels":
                pass   # handled by data/voxelizer.py downstream
            elif name == "downsample_depth_map":
                pass   # applies to depth maps, not points; see
                # downsample_depth_map() used by the CaDDN image path
            else:
                raise KeyError(f"unknown processor {name!r}")
        return points


def encode_point_features(points: np.ndarray,
                          used_feature_list: Sequence[str] = ("x", "y", "z", "intensity"),
                          src_feature_list: Sequence[str] = ("x", "y", "z", "intensity")
                          ) -> np.ndarray:
    """absolute_coordinates_encoding (pcdet point_feature_encoder.py:43-57):
    keep xyz, then append each used non-xyz feature by its source column."""
    assert tuple(src_feature_list[:3]) == ("x", "y", "z")
    cols = [points[:, 0:3]]
    for name in used_feature_list:
        if name in ("x", "y", "z"):
            continue
        idx = list(src_feature_list).index(name)
        cols.append(points[:, idx:idx + 1])
    return np.concatenate(cols, axis=1)
