"""Fixed-shape DetBatch assembly for the detection data adapters
(data/detbatch.py; pcdet DatasetTemplate.prepare_data + collate_batch):
voxelize, pad every ragged field to a static cap with validity masks, and
build the host sparse-conv rulebook (data/rulebook.py).

Any frame provider with ``frame(idx) -> {"points", "gt_boxes",
"gt_classes"}`` and a ``range`` attribute (data/kitti.py:
KittiDataset) assembles batches through ``assemble_det_batch``; the
batch's tensors lie on ``device``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def assemble_det_batch(dataset, indices: Sequence[int], voxel_size,
                       max_voxels: int, max_points_per_voxel: int = 5,
                       max_points: int = 16384, max_gt: int = 50,
                       rulebook_caps=None, num_features: int = 4,
                       x_window: bool = False, device="cpu"):
    """Voxelize and pad ``dataset.frame(idx)`` outputs into one DetBatch.

    x_window: also emit the packed x-window maps (needed only by a detector
    with ``DetectorConfig.x_window``)."""
    from ..detection.detectors import DetBatch
    from .rulebook import build_rulebook
    from .voxelizer import Voxelizer

    rng = dataset.range
    b = len(indices)
    nx, ny, nz = [int(round((rng[i + 3] - rng[i]) / voxel_size[i]))
                  for i in range(3)]
    vx = np.zeros((b, max_voxels, max_points_per_voxel, num_features),
                  np.float32)
    vc = np.full((b, max_voxels, 3), -1, np.int32)
    vn = np.zeros((b, max_voxels), np.int32)
    vv = np.zeros((b, max_voxels), bool)
    pts_pad = np.zeros((b, max_points, num_features), np.float32)
    pts_valid = np.zeros((b, max_points), bool)
    gt = np.zeros((b, max_gt, 7), np.float32)
    gtc = np.zeros((b, max_gt), np.int32)
    gtv = np.zeros((b, max_gt), bool)
    rbs = []
    caps = rulebook_caps or (max_voxels, max_voxels, max_voxels // 2,
                             max_voxels // 4)
    voxelizer = Voxelizer(voxel_size, rng, max_points_per_voxel, max_voxels)
    for i, idx in enumerate(indices):
        fr = dataset.frame(idx)
        p = fr["points"][:max_points, :num_features]
        pts_pad[i, :len(p)] = p
        pts_valid[i, :len(p)] = True
        voxels, coords, num = voxelizer(fr["points"][:, :num_features])
        n = len(voxels)
        vx[i, :n], vc[i, :n], vn[i, :n] = voxels, coords, num
        vv[i, :n] = True
        g = fr["gt_boxes"][:max_gt]
        gt[i, :len(g)] = g[:, :7]
        gtc[i, :len(g)] = fr["gt_classes"][:max_gt]
        gtv[i, :len(g)] = True
        rbs.append(build_rulebook(vc[i], n, (nz + 1, ny, nx), caps,
                                  x_window=x_window))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    rulebook = {k: t(np.stack([rb[k] for rb in rbs])) for k in rbs[0]}
    return DetBatch(
        voxels=t(vx), voxel_coords=t(vc), voxel_num_points=t(vn),
        voxel_valid=t(vv), gt_boxes=t(gt), gt_classes=t(gtc),
        gt_valid=t(gtv), rulebook=rulebook, points=t(pts_pad),
        point_valid=t(pts_valid))
