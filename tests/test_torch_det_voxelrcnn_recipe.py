"""VoxelRCNN-Det trained at voxel_rcnn_car.yaml's recipe (one-cycle Adam,
the proposal NMS 9000 -> 512 cut in the YAML's ratio) against the
benchmark's plain reference (h100_bench/reference/voxelrcnn.py, imported
by path) at the benchmark's tiny size on the CPU, and the one-cycle
schedule against values worked out by hand.

Both sides take the same seeded weights (the reference draws them anew
from the seed), the same voxels and cars (the program's batch carries the
host rulebook; the reference builds its maps on the device) and the same
sampler and dropout draws (both reseed from (seed, step)). Two steps are
compared: every loss, every clipped gradient as the optimizer gets it, the
first step's NMS proposals (exactly) and the weights after the two
updates. Tolerance 1e-5 of each
tensor's largest reference magnitude: the two run the same float32
operations in the same order (0 apart in every run so far), and the room
is for a BLAS that blocks a product differently between two calls.
"""
import math
import os
import sys

import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100_bench")
for _p in (os.path.join(BENCH, "tests"), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402
from tiny_voxelrcnn import tiny_spec  # noqa: E402

from multimodal_gar_tpu_torch.detection.train import (  # noqa: E402
    OneCycleConfig, create_det_train_state, make_det_train_step,
    one_cycle_at)

TOL = 1e-5
SEED = 2 ** 31 + 21


def _close(got, ref, what):
    scale = max(float(ref.abs().max()), 1e-12)
    err = float((got - ref).abs().max())
    assert err <= TOL * scale, (what, err, scale)


def _port_model(cfgj, seed):
    from multimodal_gar_tpu_torch.config import Config, LiDARBackboneConfig
    from multimodal_gar_tpu_torch.detection.detectors import DetectorConfig
    from multimodal_gar_tpu_torch.detection.roi_detectors import (
        RoIHeadConfig)
    from multimodal_gar_tpu_torch.models.registry import build_model
    ref = harness.load_module("reference", "voxelrcnn.py")
    det, roi, pool, cycle = ref.configs(cfgj, {
        "DetectorConfig": DetectorConfig, "RoIHeadConfig": RoIHeadConfig,
        "LiDARBackboneConfig": LiDARBackboneConfig,
        "OneCycleConfig": OneCycleConfig})
    d = cfgj["detector"]
    cfg = harness.apply_overrides(Config(), {"data": {"point_cloud": {
        "range": d["point_cloud_range"], "num_point_features": 4,
        "voxel": {"voxel_size": d["voxel_size"]}}}})
    model = build_model(cfg, "VoxelRCNN-Det", device="cpu", det_cfg=det,
                        roi_cfg=roi, lidar_cfg=pool)
    harness.load_weights_(model, ref.seeded_detector_weights(
        model.state_dict(), seed, "cpu"))
    return model, cycle


def test_two_steps_match_the_plain_reference():
    spec = tiny_spec(SEED)
    cfgj = spec["config"]
    nms = cfgj["roi_head"]["train_nms"]
    assert nms["nms_pre_maxsize"] / nms["nms_post_maxsize"] == \
        pytest.approx(9000 / 512, rel=0.01)
    ref = harness.load_module("reference", "voxelrcnn.py")
    from reference.frozen.detection import train as ref_train
    drv = harness.load_module("drivers", "voxelrcnn.py")
    pool = drv.Cell(spec)._pool(False)
    opt = cfgj["optimizer"]

    port, cycle = _port_model(cfgj, SEED)
    mine = ref.model(cfgj, SEED, "cpu")
    names = [n for n, _ in port.named_parameters()]
    assert names == [n for n, _ in mine.named_parameters()]
    kw = dict(weight_decay=opt["weight_decay"],
              clip_norm=opt["grad_norm_clip"], optimizer="adam_onecycle",
              one_cycle=cycle)
    p_state = create_det_train_state(port, **kw)
    r_state = ref_train.create_det_train_state(mine, **kw)
    p_step = make_det_train_step(port, p_state, seed=7)
    r_step = ref_train.make_det_train_step(mine, r_state, seed=7)
    p_props, r_props = [], []
    hooks = [ref.capture_proposals(port, p_props),
             ref.capture_proposals(mine, r_props)]
    for i in range(2):
        got = p_step(pool[i].batch)
        want = r_step(ref.det_batch(pool[i], "cpu"))
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"step {i} loss {k}")
        for (n, p), q in zip(port.named_parameters(), mine.parameters()):
            _close(p.grad, q.grad, f"step {i} gradient {n}")
        if i == 0:
            (pr, pv), (rr, rv) = p_props[0], r_props[0]
            assert torch.equal(pv, rv) and torch.equal(pr[pv], rr[rv])
            assert int(rv.sum()) == 2 * nms["nms_post_maxsize"]
    for h in hooks:
        h.remove()
    assert p_state.step == r_state.step == 2
    for (n, p), q in zip(port.named_parameters(), mine.parameters()):
        _close(p.detach(), q.detach(), f"weights after two updates {n}")
    moved = sum(float((p.grad != 0).any()) for p in port.parameters())
    assert moved > 0.9 * len(names)


def test_one_cycle_schedule_by_hand():
    """OpenPCDet's OneCycle at LR 0.01, div_factor 10, pct_start 0.4,
    moms (0.95, 0.85) over 100 steps: a half cosine from 0.001 up to 0.01
    and beta1 from 0.95 down to 0.85 over steps 0-40, then down to 1e-7 and
    back to 0.95 at step 100."""
    cfg = OneCycleConfig(total_steps=100)
    want = {0: (0.001, 0.95), 20: (0.0055, 0.90), 40: (0.01, 0.85),
            70: (0.01 + (1e-7 - 0.01) * 0.5, 0.90), 100: (1e-7, 0.95)}
    for step, (lr, beta1) in want.items():
        got = one_cycle_at(cfg, step)
        assert got == pytest.approx((lr, beta1), rel=1e-9, abs=1e-15), step
    mid = one_cycle_at(cfg, 10)
    assert mid[0] == pytest.approx(0.01 + (0.001 - 0.01) / 2
                                   * (math.cos(math.pi * 0.25) + 1))


def test_one_cycle_step_sets_the_group_and_decays_every_weight():
    """At step k the optimizer gets the schedule's lr and beta1, betas[1]
    stays 0.99, and a step with zero gradients moves each weight by the
    decoupled decay alone: p * (1 - wd * lr)."""
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(2.0)
        model.bias.fill_(-1.0)
    cfg = OneCycleConfig(total_steps=100)
    state = create_det_train_state(model, weight_decay=0.01,
                                   optimizer="adam_onecycle", one_cycle=cfg)
    state.step = 40
    from multimodal_gar_tpu_torch.detection.train import _optimizer_step
    for p in state.params:
        p.grad = torch.zeros_like(p)
    _optimizer_step(state)
    group = state.optimizer.param_groups[0]
    assert group["lr"] == pytest.approx(0.01)
    assert group["betas"] == pytest.approx((0.85, 0.99))
    assert torch.equal(model.weight, torch.full((2, 3), 2.0 * (1 - 1e-4),
                                                dtype=torch.float32))
    assert torch.equal(model.bias, torch.full((2,), -1.0 * (1 - 1e-4)))
    with pytest.raises(ValueError):
        create_det_train_state(model, optimizer="adam_onecycle")
