"""Operations and least bytes of a Voxel R-CNN training step, worked out
from the configuration's widths, the step's own voxels and the NMS's
program counters, whatever implements them.

- VoxelBackbone8x's 11 sparse convs, as counts/mgar.py counts them (present
  taps of the benchmark's own map rule over each image's voxels), on index
  maps (27 int32 a row) in the forward (``sparse_fwd``, K3's
  ``subm_conv_kernel``), with the data (``sparse_dgrad``) and weight
  (``sparse_wgrad``) gradients of a step.
- The dense layers whose widths the configuration fixes: BaseBEVBackbone's
  3 x 3 convs and deblocks over the 200 x 176 BEV map, the RPN's 1 x 1
  heads, and the refinement MLP over each image's sampled RoIs: forward,
  data and weight gradient at 2 x Cin x Cout a tap and output site.
  conv_out, the grid pool's MLPs, the losses and the proposal path are left
  out (a few percent), so ``mfu`` is a slight underestimate.
- The NMS (``nms``): operations, FLOP_PER_CLIP for each pair of proposals
  whose rectangles truly overlap (the program's counter
  ``nms.overlap_pairs``: the pairs whose exact overlap no correct NMS can
  skip); least bytes, the proposals read once and the upper triangle of the
  suppression words written once (the words of row i from its own 64-box
  block on), for each call at the configuration's pre-NMS count.
"""
from __future__ import annotations

import math
from typing import Dict, List

from harness import load_module

F32 = 4
# the side tests of a clip, a lower bound: 4 edges x 4 vertices x (2
# multiplications, 2 subtractions); the crossings and the area are left out
FLOP_PER_CLIP = 64

mgar = load_module("counts", "mgar.py")


def _stage_shapes(cfgj: dict):
    from reference.frozen.ops.device_rulebook import (conv_out_shape,
                                                      stage_shape)
    d = cfgj["detector"]
    pr, vs = d["point_cloud_range"], d["voxel_size"]
    nx, ny, nz = (int(round((pr[i + 3] - pr[i]) / vs[i])) for i in range(3))
    shape = (nz + 1, ny, nx)
    for k in (1, 2, 3):
        shape = stage_shape(shape, k)
    return shape, conv_out_shape(shape, (3, 1, 1), (2, 1, 1), 0)


def dense_flop(cfgj: dict) -> float:
    """Forward operations of the BEV trunk, the RPN heads and the
    refinement MLP for one image."""
    d, r = cfgj["detector"], cfgj["roi_head"]
    _, out = _stage_shapes(cfgj)
    c, h, w = out[0] * 128, out[1], out[2]
    flop, up = 0.0, 0
    for n, s, f, us, cu in zip(d["bev_layer_nums"], d["bev_layer_strides"],
                               d["bev_num_filters"],
                               d["bev_upsample_strides"],
                               d["bev_num_upsample_filters"]):
        h, w = math.ceil(h / s), math.ceil(w / s)
        flop += 2.0 * 9 * c * f * h * w + n * 2.0 * 9 * f * f * h * w
        flop += 2.0 * f * cu * (h * us) * (w * us)
        c, up = f, up + cu
    hw = out[1] * out[2]
    anchors = sum(len(a["anchor_sizes"]) * len(a["anchor_rotations"])
                  for a in d["anchors"])
    head = d["head"]
    outs = anchors * (head["num_class"] + 7 + head["num_dir_bins"])
    flop += 2.0 * up * outs * hw
    pool = cfgj["grid_pool"]["pool_layers"]
    cin = r["grid_size"] ** 3 * sum(p["mlps"][1] for p in pool)
    mlp = 0.0
    for widths, last in ((r["shared_fc"], None), (r["cls_fc"], 1),
                         (r["reg_fc"], 7)):
        c = cin if last is None else r["shared_fc"][-1]
        for wd in widths:
            mlp += 2.0 * c * wd
            c = wd
        if last:
            mlp += 2.0 * c * last
    return flop + mlp * r["num_rois_train"]


def step_counts(cfgj: dict, batch, device) -> Dict[str, float]:
    """Counts of one training step on ``batch`` (a host DetBatch)."""
    d, v = cfgj["detector"], cfgj["voxelization"]
    pr, vs = d["point_cloud_range"], d["voxel_size"]
    nx, ny, nz = (int(round((pr[i + 3] - pr[i]) / vs[i])) for i in range(3))
    out: Dict[str, float] = {}
    for i in range(batch.voxel_coords.shape[0]):
        layers = mgar.sparse_layers(
            batch.voxel_coords[i:i + 1], batch.voxel_valid[i:i + 1],
            (nz + 1, ny, nx), cfgj["stage_caps"]["train"],
            v["num_point_features"], device)
        for k, x in mgar.sparse_counts(layers, True, 27).items():
            out[k] = out.get(k, 0.0) + x
    out["flop"] = 3.0 * dense_flop(cfgj) * batch.voxel_coords.shape[0] \
        + out["sparse_fwd_flop"] + out["sparse_dgrad_flop"] \
        + out["sparse_wgrad_flop"]
    return out


def nms_bytes(n: int) -> float:
    """Least bytes of one NMS over ``n`` proposals: the boxes read, the
    upper triangle of the suppression words written."""
    words = n // 64 + (n % 64 > 0)
    written = sum(words - i // 64 for i in range(n))
    return float(F32 * 7 * n + 8 * written)


def nms_counts(cfgj: dict, counters: Dict[str, int],
               calls: int) -> Dict[str, float]:
    """The NMS's counts over ``calls`` proposal NMS calls (one an image a
    step), from the program's counters; nothing where the program counts
    nothing."""
    if "nms.overlap_pairs" not in counters:
        return {}
    nms = cfgj["roi_head"]["train_nms"]
    n = min(nms["nms_pre_maxsize"], anchor_count(cfgj))
    return {"nms_flop": float(FLOP_PER_CLIP * counters["nms.overlap_pairs"]),
            "nms_bytes": calls * nms_bytes(n)}


def anchor_count(cfgj: dict) -> int:
    """The RPN's anchors over the BEV map (70,400 at KITTI's Car)."""
    d = cfgj["detector"]
    pr, vs = d["point_cloud_range"], d["voxel_size"]
    nx, ny = (int(round((pr[i + 3] - pr[i]) / vs[i])) for i in range(2))
    return sum(len(a["anchor_sizes"]) * len(a["anchor_rotations"])
               * len(a["anchor_bottom_heights"])
               * (nx // a["feature_map_stride"])
               * (ny // a["feature_map_stride"]) for a in d["anchors"])


def total(per_step: List[dict], served: List[int]) -> Dict[str, float]:
    """Sums of the counts over the served steps (indices into the pool)."""
    out: Dict[str, float] = {}
    for i in served:
        for k, v in per_step[i].items():
            out[k] = out.get(k, 0.0) + v
    return out
