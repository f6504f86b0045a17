"""The port's training loop on ``device="cpu"`` at the tiny config of
tests/test_train_loop.py: a run end to end, the stages' hand-over, the
decode workers, the I3D checkpoint and the card requirement of the entry
points (helpers: tests/test_torch_loop_common.py)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import multimodal_gar_tpu_torch.config as port_config
from multimodal_gar_tpu_torch.__main__ import main
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.train.loop import run_eval, run_training
from tests.test_torch_loop_common import (tiny_training_cfg, jrdb_root, _log,
                                          _snapshot)


def test_run_training_end_to_end(jrdb_root, tmp_path):
    workdir = str(tmp_path / "run")
    metrics = run_training(tiny_training_cfg(port_config, jrdb_root), workdir,
                           max_steps_per_epoch=2, device="cpu")
    for key in ("overall_AP", "action_AP", "activity_AP", "score"):
        assert key in metrics, key
        assert np.isfinite(metrics[key])
    rows = _log(workdir)
    assert [r["step"] for r in rows if "train/loss" in r] == [1, 2]
    assert any("val/overall_AP" in r for r in rows)
    assert any("time/train_s" in r for r in rows)
    with open(os.path.join(workdir, "checkpoints", "best.json")) as f:
        best = json.load(f)
    assert best["step"] == 2 and best["score"] == metrics["score"]
    assert os.path.exists(os.path.join(workdir, "checkpoints", "step_2.pt"))
    results = os.path.join(workdir, "results", "s0_e0")
    for name in ("grouping.txt", "action.txt", "activity.txt"):
        assert os.path.exists(os.path.join(results, name))


def test_cross_stage_param_persistence(jrdb_root, tmp_path):
    """Stage 2 starts from stage 1's trained weights and BatchNorm
    statistics with a fresh optimizer (zero Adam moments)."""
    cfg = tiny_training_cfg(port_config, jrdb_root, stages=(
        (1, 1e-3, "L_total"), (1, 3e-4, "L_total")))
    snaps = {}
    run_training(cfg, str(tmp_path / "run2"), max_steps_per_epoch=2,
                 resume=False, device="cpu",
                 on_stage_start=lambda i, s: snaps.setdefault(
                     ("start", i), _snapshot(s)),
                 on_stage_end=lambda i, s: snaps.setdefault(
                     ("end", i), _snapshot(s)))
    start1, end1 = snaps[("start", 0)], snaps[("end", 0)]
    start2, end2 = snaps[("start", 1)], snaps[("end", 1)]
    for k, v in end1["model"].items():
        assert torch.equal(start2["model"][k], v), k
    assert any(not torch.equal(start1["model"][k], v)
               for k, v in start2["model"].items())
    fresh, used = start2["optimizer"], end1["optimizer"]
    assert fresh["updates"] == 0 and fresh["mini_step"] == 0
    assert used["updates"] == 2
    for key in ("exp_avg", "exp_avg_sq", "acc"):
        assert all(not t.any() for t in fresh[key]), key
    assert any(t.any() for t in used["exp_avg"])
    assert (start2["step"], end2["step"]) == (2, 4)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(jrdb_root,
                                                             tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    cfg = tiny_training_cfg(port_config, jrdb_root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_eval(cfg, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MGAR(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--workdir", str(tmp_path / "b"),
              "--set", f"data.root={jrdb_root}"])
    assert not os.path.exists(tmp_path / "a" / "checkpoints")


def test_training_and_eval_run_with_decode_workers(jrdb_root, tmp_path):
    """``train.num_workers`` 2: run_training and run_eval decode in worker
    processes and give the metrics of the run with the producer thread,
    exactly (the stream is the same, byte for byte)."""
    serial = tiny_training_cfg(port_config, jrdb_root)
    pooled = dataclasses.replace(serial, train=dataclasses.replace(
        serial.train, num_workers=2))
    ref = run_training(serial, str(tmp_path / "serial"),
                       max_steps_per_epoch=2, device="cpu")
    got = run_training(pooled, str(tmp_path / "pooled"),
                       max_steps_per_epoch=2, device="cpu")
    assert got == ref
    evaluated = run_eval(pooled, str(tmp_path / "pooled"), device="cpu")
    assert evaluated == {k: v for k, v in ref.items() if k != "score"}


def test_build_model_loads_the_i3d_checkpoint(jrdb_root, tmp_path):
    """``model.rgb.i3d_checkpoint``: the I3D's tensors come from the file,
    everything else from the seeded draw; an RGB-less model ignores it."""
    from multimodal_gar_tpu_torch.train.loop import _build_model
    cfg = tiny_training_cfg(port_config, jrdb_root)
    plain = _build_model(cfg, torch.device("cpu"))
    i3d = plain.rgb_backbone.i3d.state_dict()
    ckpt = {k: torch.full_like(v, 0.25) for k, v in i3d.items()}
    ckpt["logits.conv3d.weight"] = torch.zeros((400, 1024, 1, 1, 1))
    path = str(tmp_path / "rgb_imagenet.pt")
    torch.save(ckpt, path)

    def with_ckpt(c):
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, rgb=dataclasses.replace(c.model.rgb,
                                             i3d_checkpoint=path)))
    loaded = _build_model(with_ckpt(cfg), torch.device("cpu"))
    for k, v in loaded.state_dict().items():
        if k.startswith("rgb_backbone.i3d."):
            assert torch.equal(v, torch.full_like(v, 0.25)), k
        else:
            assert torch.equal(v, plain.state_dict()[k]), k
    lidar_only = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fusion=dataclasses.replace(cfg.model.fusion,
                                              modality="LiDAR")))
    assert _build_model(with_ckpt(lidar_only),
                        torch.device("cpu")).rgb_backbone is None
