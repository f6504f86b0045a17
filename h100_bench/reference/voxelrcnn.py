"""The plain reference of the voxelrcnn cells: the frozen copy of the port's
Voxel R-CNN path (reference/frozen/detection/), every hand-written kernel
replaced by its plain version, float32 with TF32 off (``tf32=True`` is the
control).

It takes the configuration file, the seed (the weights are drawn anew
from it, as for the program), the benchmark-made frames' labelled cars and
the voxels of the program's batch, made at set-up before any timed step
(data/detbatch.py: assemble_det_batch, the port's voxelizer). The voxels
are taken, not remade: the port's native voxelizer places a point that
lies within float32 rounding of a voxel face by float32 arithmetic, the
benchmark's copy (traffic/voxelize.py) by float64, so 2-3 of 16,000 voxels
of a frame differ, and one voxel moves the sparse BatchNorms' batch
statistics and with them every proposal. So the voxelizer is not
compared here, and the loss is read but not held (the grid pool's voxel
query rounds its squared distances at 70 m by more than a RoI's drift):
both are open items, not the cell's design. Once the voxelizer's
arithmetic is settled and the query's distances are formed from the
box's centre on both sides, the reference voxelizes the frames itself
and ``first_loss_rel_gap`` gets a limit calibrated against the control.
From the voxels on, the
reference builds its sparse maps on the device (the frozen
ops/device_rulebook.py), runs the index-map path and its own NMS: the IoU
of each proposal with those after it in blocks of rows, swept one box at a
time on the host (reference/frozen/ops/boxes3d.py). The program's
rulebook and kernels are left out.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from harness import apply_overrides, load_module, load_weights_, seeded_weights

# a program proposal matches a reference proposal when every coordinate
# lies within this many metres (radians for the heading): 100 times a
# float32 ulp of a 70 m coordinate, far below any box's extent
PROPOSAL_TOL = 1e-3


def configs(cfgj: dict, mods: dict):
    """(DetectorConfig, RoIHeadConfig, LiDARBackboneConfig, OneCycleConfig)
    of a configuration file, from the classes in ``mods`` (the program's or
    the frozen copy's)."""
    det = apply_overrides(mods["DetectorConfig"](), dict(
        cfgj["detector"], max_voxels_per_stage=cfgj["stage_caps"]["train"]))
    roi = apply_overrides(mods["RoIHeadConfig"](), cfgj["roi_head"])
    pool = apply_overrides(mods["LiDARBackboneConfig"](), cfgj["grid_pool"])
    opt = cfgj["optimizer"]
    cycle = mods["OneCycleConfig"](
        total_steps=opt["total_steps"], lr_max=opt["lr_max"],
        moms=tuple(opt["moms"]), div_factor=opt["div_factor"],
        pct_start=opt["pct_start"])
    return det, roi, pool, cycle


# OpenPCDet's initial values of the box regressions (anchor_head_single:
# normal std 0.001 for conv_box; voxelrcnn_head: the same for reg_layers),
# each with bias 0, and the focal prior of the RPN's class logits (bias
# -log((1 - 0.01) / 0.01))
BOX_INIT_STD = 0.001
BOX_LEAVES = ("dense_head.conv_box", "rcnn_head.reg_out")
CLS_PRIOR_BIAS = -float(np.log((1 - 0.01) / 0.01))


def seeded_detector_weights(state, seed: int, device) -> dict:
    """The weights of a cell drawn from ``seed``: harness.seeded_weights,
    then the box regressions at OpenPCDet's initial scale and the RPN's
    class prior, so that the proposals are the anchors nudged, as at the
    start of training where the cell's window lies."""
    w = seeded_weights(state, seed, device)
    for leaf in BOX_LEAVES:
        t = w[leaf + ".weight"]
        fan_in = t[0].numel()
        w[leaf + ".weight"] = t * (BOX_INIT_STD * fan_in ** 0.5)
        w[leaf + ".bias"] = torch.zeros_like(w[leaf + ".bias"])
    w["dense_head.conv_cls.bias"] = torch.full_like(
        w["dense_head.conv_cls.bias"], CLS_PRIOR_BIAS)
    return w


def _frozen():
    from reference.frozen.config import LiDARBackboneConfig
    from reference.frozen.detection.detectors import DetectorConfig
    from reference.frozen.detection.roi_detectors import RoIHeadConfig
    from reference.frozen.detection.train import OneCycleConfig
    return {"DetectorConfig": DetectorConfig, "RoIHeadConfig": RoIHeadConfig,
            "LiDARBackboneConfig": LiDARBackboneConfig,
            "OneCycleConfig": OneCycleConfig}


def model(cfgj: dict, seed: int, device):
    """The frozen VoxelRCNN with the weights drawn from ``seed``."""
    from reference.frozen.detection.roi_detectors import VoxelRCNNDetector
    det, roi, pool, _ = configs(cfgj, _frozen())
    m = VoxelRCNNDetector(
        det, roi, pool, cfgj["voxelization"]["num_point_features"],
        device=device, generator=torch.Generator().manual_seed(0))
    load_weights_(m, seeded_detector_weights(m.state_dict(), seed, device))
    return m


def det_batch(sample, device):
    """The frozen DetBatch of a pool sample: the voxels of the program's
    batch (host tensors made at set-up) and the labelled cars of the
    benchmark-made frames, padded to ``sample.max_gt``; no rulebook."""
    from reference.frozen.detection.detectors import DetBatch
    b = sample.batch
    g = sample.max_gt
    boxes = np.zeros((len(sample.frames), g, 7), np.float32)
    cls = np.zeros((len(sample.frames), g), np.int32)
    valid = np.zeros((len(sample.frames), g), bool)
    for i, f in enumerate(sample.frames):
        n = len(f["gt_boxes"])
        boxes[i, :n] = f["gt_boxes"][:, :7]
        cls[i, :n] = f["gt_classes"]
        valid[i, :n] = True
    return DetBatch(
        voxels=b.voxels.to(device), voxel_coords=b.voxel_coords.to(device),
        voxel_num_points=b.voxel_num_points.to(device),
        voxel_valid=b.voxel_valid.to(device),
        gt_boxes=torch.from_numpy(boxes).to(device),
        gt_classes=torch.from_numpy(cls).to(device),
        gt_valid=torch.from_numpy(valid).to(device))


def capture_proposals(net: torch.nn.Module, store: list):
    """A forward hook that keeps each training forward's NMS proposals
    (``proposal_rois``, ``proposal_valid``) on the host in ``store``."""
    def hook(_module, _inputs, out):
        if "proposal_rois" in out:
            store.append((out["proposal_rois"].detach().cpu(),
                          out["proposal_valid"].detach().cpu()))
    return net.register_forward_hook(hook)


def train_readings(cfgj: dict, wl: dict, seed: int, dropout_seed: int,
                   pool: List, device, tf32: bool = False) -> dict:
    """The reference's readings of the first ``checked_updates`` steps (one
    update a step): each step's loss, each trainable leaf's first gradient
    norm as Adam got it, each leaf's change over the steps, and the first
    step's proposals. Later steps' proposals are not kept: the first
    update moves every weight by about the learning rate times the sign of
    its gradient, also where the gradient is round-off, so that the
    proposals after it differ between two sound runs by more than
    PROPOSAL_TOL; the update is held by the change norms instead."""
    from reference.frozen.detection.train import (create_det_train_state,
                                                  make_det_train_step)
    compare = load_module("reference", "compare.py")
    opt = cfgj["optimizer"]
    with compare.precision(tf32):
        net = model(cfgj, seed, device)
        _, _, _, cycle = configs(cfgj, _frozen())
        state = create_det_train_state(
            net, weight_decay=opt["weight_decay"],
            clip_norm=opt["grad_norm_clip"], optimizer=opt["name"],
            one_cycle=cycle)
        step = make_det_train_step(net, state, seed=dropout_seed)
        proposals: list = []
        handle = capture_proposals(net, proposals)
        out = compare.train_readings(
            net, state.params, state.optimizer,
            lambda i: step(det_batch(pool[i], device)),
            wl["checked_updates"], 1, len(pool))
        handle.remove()
    out["proposals"] = proposals[:1]
    del net, state, step
    return out


def proposal_mismatch_share(got: list, want: list) -> float:
    """The symmetric difference of the program's and the reference's valid
    proposals over their union, over every image of the steps given (the
    first: ``train_readings``): a proposal of either side counts as
    unmatched where no valid proposal of the other side lies within
    PROPOSAL_TOL on every coordinate; the union is the reference's
    proposals and the program's unmatched ones. A missing step on either
    side, or none at all, reads as inf."""
    if len(got) != len(want) or not want:
        return float("inf")
    unmatched = union = 0
    for (g_rois, g_valid), (w_rois, w_valid) in zip(got, want):
        for gr, gv, wr, wv in zip(g_rois, g_valid, w_rois, w_valid):
            ref, mine = wr[wv].double(), gr[gv].double()
            if ref.shape[0] == 0 or mine.shape[0] == 0:
                unmatched += ref.shape[0] + mine.shape[0]
                union += ref.shape[0] + mine.shape[0]
                continue
            close = (ref[:, None, :] - mine[None, :, :]).abs().amax(-1) \
                <= PROPOSAL_TOL
            ref_out = int((~close.any(dim=1)).sum())
            mine_out = int((~close.any(dim=0)).sum())
            unmatched += ref_out + mine_out
            union += ref.shape[0] + mine_out
    return unmatched / union if union else 0.0
