"""The LiDAR branch (models/lidar_backbone.py, sparse_backbone.py,
roi_grid_pool.py, ops/voxel.py) of a request:
the mean of the span "lidar_branch" over the window (harness.span_mean_ms)."""
from harness import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "eval", "lidar_branch")
