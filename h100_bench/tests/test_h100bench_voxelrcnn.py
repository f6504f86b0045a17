"""The voxelrcnn cell: found by name, its frames, its counts, its readers,
and its reference against the port at a tiny size on the CPU: a sound run
comes out correct, and a run with a fault planted under the timed path
(faults_voxelrcnn.py: the NMS threshold, the NMS pre-size, the optimizer)
comes out not correct. On the card, the control (the reference at TF32 in
the program's place) fails the cell's numbers."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import harness
import run
from conftest import BENCH, ROOT
from tiny_voxelrcnn import FAULT_NMS, tiny_spec

CELL = "voxelrcnn-train-b2"
counts = harness.load_module("counts", "voxelrcnn.py")


def test_the_cell_is_found_by_name():
    spec = run.cell_spec(CELL, 2 ** 31 + 3, "cpu")
    assert spec["config"]["family"] == "voxelrcnn"
    assert spec["config"]["reduced"] == []
    assert spec["mix"]["generator"] == "kitti_frames"
    assert spec["workload"] == {"loop": "train", "batch": 2,
                                "checked_updates": 2}
    nms = spec["config"]["roi_head"]["train_nms"]
    assert (nms["nms_pre_maxsize"], nms["nms_post_maxsize"],
            nms["nms_thresh"]) == (9000, 512, 0.8)
    assert spec["config"]["optimizer"]["name"] == "adam_onecycle"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in ("nms_ms.train", "nms_roofline.train", "proposals_ms.train",
                 "det_grid_pool_ms.train", "det_backward_ms.train"):
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL]
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py"))


def test_frames_follow_the_seed_and_the_mix():
    mix = harness.load_json("traffic", "mixes", "kitti-car-train.json")
    gen = harness.load_module("traffic", "kitti_frames.py")
    p, seed = mix["params"], 2 ** 31 + 77
    a = gen.frame(p, seed, 3, mix["pool"])
    b = gen.frame(p, seed, 3, mix["pool"])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(gen.frame(p, seed + 1, 3, 16)["points"],
                              a["points"])
    cars = sorted(len(gen.frame(p, seed, i, 16)["gt_boxes"])
                  for i in range(16))
    assert cars[0] == 10 and cars[-1] == 25
    pts, r = a["points"], p["range"]
    assert pts.shape == (p["points"], 4) and pts.dtype == np.float32
    assert (pts[:, 0] > r[0]).all() and (pts[:, 0] < r[3]).all()
    assert (np.abs(pts[:, 1]) < r[4]).all()
    assert (pts[:, 2] > r[2]).all() and (pts[:, 2] < r[5]).all()
    assert (a["gt_classes"] == 1).all()


def test_counts_by_hand():
    assert counts.nms_bytes(1) == 4 * 7 + 8
    # 65 boxes: rows 0-63 write 2 words, row 64 one
    assert counts.nms_bytes(65) == 4 * 7 * 65 + 8 * (64 * 2 + 1)
    cfgj = harness.load_json("configs", "voxelrcnn-kitti-car.json")
    assert counts.anchor_count(cfgj) == 70400
    got = counts.nms_counts(cfgj, {"nms.overlap_pairs": 10}, 4)
    assert got == {"nms_flop": 640.0, "nms_bytes": 4 * counts.nms_bytes(9000)}
    assert counts.nms_counts(cfgj, {}, 4) == {}
    # the BEV trunk: 256 channels in (2 x 128 after conv_out) at 200 x 176
    hw = 200 * 176
    bev = (2 * 9 * 256 * 64 * hw + 5 * 2 * 9 * 64 * 64 * hw
           + 2 * 64 * 128 * hw
           + 2 * 9 * 64 * 128 * hw / 4 + 5 * 2 * 9 * 128 * 128 * hw / 4
           + 2 * 128 * 128 * hw)
    head = 2 * 256 * 2 * (1 + 7 + 2) * hw
    assert counts.dense_flop(cfgj) > bev + head
    assert counts.dense_flop(cfgj) == pytest.approx(bev + head, rel=0.1)


def test_step_counts_are_the_sparse_layers_of_each_image():
    spec = tiny_spec(2 ** 31 + 5)
    drv = harness.load_module("drivers", "voxelrcnn.py")
    cell = drv.Cell(spec)
    batch = cell._pool(False)[0].batch
    got = counts.step_counts(spec["config"], batch, "cpu")
    mgar = harness.load_module("counts", "mgar.py")
    d = spec["config"]["detector"]
    shape = (41, 256, 256)
    want = 0.0
    for i in range(2):
        layers = mgar.sparse_layers(batch.voxel_coords[i:i + 1],
                                    batch.voxel_valid[i:i + 1], shape,
                                    spec["config"]["stage_caps"]["train"],
                                    4, "cpu")
        want += mgar.sparse_counts(layers, True, 27)["sparse_fwd_flop"]
    assert got["sparse_fwd_flop"] == want > 0
    assert got["flop"] > got["sparse_fwd_flop"] + got["sparse_wgrad_flop"]
    assert d["voxel_size"] == [0.05, 0.05, 0.1]


def test_the_new_readers_find_nothing_without_a_trace():
    for name in ("nms_ms", "nms_roofline", "proposals_ms", "det_grid_pool_ms",
                 "det_backward_ms"):
        reader = harness.load_module("metrics", f"{name}.train.py")
        assert reader.read({}) is None
        assert reader.read({"loop": "eval"}) is None
    roof = harness.load_module("metrics", "nms_roofline.train.py")
    assert roof.read({"loop": "train", "platform": "gpu",
                      "traced_counts": {"sparse_fwd_flop": 1.0}}) is None


def _run(seed=13):
    result, checks = run.run_cell(tiny_spec(seed, nms=FAULT_NMS), 0.5, False)
    assert result is not None, checks
    return result, checks


def test_a_sound_run_is_correct():
    result, checks = _run()
    assert result["correct"], checks
    names = {c["name"] for c in checks}
    assert names == set(tiny_spec(1)["config"]["limits"]["train"])
    assert all(c["limit"] is not None for c in checks)


@pytest.mark.parametrize("fault", ["nms_thresh_07", "nms_pre_512",
                                   "adamw_not_onecycle"])
def test_a_fault_is_caught(fault):
    import faults_voxelrcnn
    with faults_voxelrcnn.FAULTS[fault]():
        result, checks = _run()
    assert not result["correct"], checks


def test_the_proposal_share_counts_both_sides_over_the_steps_given():
    """Unmatched proposals of either side over the union, summed over
    every image of the steps given; a missing step reads inf."""
    ref = harness.load_module("reference", "voxelrcnn.py")
    boxes = torch.arange(2 * 4 * 7, dtype=torch.float32).reshape(2, 4, 7)
    valid = torch.tensor([[True, True, True, False]] * 2)
    step = (boxes, valid)
    assert ref.proposal_mismatch_share([step, step], [step, step]) == 0.0
    extra = valid.clone()
    extra[1, 3] = True                   # one more program proposal
    assert ref.proposal_mismatch_share([step, (boxes, extra)],
                                       [step, step]) == 1 / 13
    moved = boxes.clone()
    moved[0, 0, 0] += 2 * ref.PROPOSAL_TOL
    # one reference proposal missed, one program proposal unmatched
    assert ref.proposal_mismatch_share([(moved, valid)], [step]) == 2 / 7
    assert ref.proposal_mismatch_share([step], [step, step]) == float("inf")


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          CELL, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_the_control_fails_on_the_card(cuda_device):
    """The reference at TF32 in the program's place, at the cell's own
    sizes: at least one number over its limit (the proposal share, which
    calibrate.readings does not report, included)."""
    import time
    seed = 2 ** 31 + 5
    spec = run.cell_spec(CELL, seed, cuda_device)
    drv = harness.load_module("drivers", "voxelrcnn.py")
    ref = harness.load_module("reference", "voxelrcnn.py")
    compare = harness.load_module("reference", "compare.py")
    cell = drv.Cell(spec)
    cell.setup(harness.SetupClock(time.perf_counter()))
    cell.release()
    args = (spec["config"], spec["workload"], seed, spec["dropout_seed"],
            cell.pool, cuda_device)
    want = ref.train_readings(*args)
    low = ref.train_readings(*args, tf32=True)
    nums = compare.train_numbers(low, want)
    nums["proposal_mismatch_share"] = ref.proposal_mismatch_share(
        low["proposals"], want["proposals"])
    limits = spec["config"]["limits"]["train"]
    assert any(nums[k] > v for k, v in limits.items()), nums
