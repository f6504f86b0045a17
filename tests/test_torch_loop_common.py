"""Shared helpers of the port's training-loop tests
(tests/test_torch_train_{loop,checkpoint,cli,determinism}.py): the tiny
training config of tests/test_train_loop.py on either package's config
module, the on-disk synthetic JRDB, and snapshots of a run's state."""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from multimodal_gar_tpu.data.synthetic import write_synthetic_jrdb
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.train.loop import run_training
from multimodal_gar_tpu_torch.train.train_state import (TrainState,
                                                        make_optimizer,
                                                        make_train_step)
from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)


def tiny_training_cfg(m, root, stages=None, grad_accum=1):
    """tests/test_train_loop.py's tiny config on config module ``m``."""
    pc = m.PointCloudConfig(
        num_points=96, range=(-6.0, -6.0, -2.0, 6.0, 6.0, 3.0),
        voxel=m.VoxelizationConfig((0.5, 0.5, 0.625), 5, 128, 128))
    data = m.DataConfig(root=root, image_size=(48, 80), num_frames=3,
                        num_boxes=6, point_cloud=pc)
    cfg = dataclasses.replace(m.Config(), data=data)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lidar=dataclasses.replace(
            cfg.model.lidar, max_voxels_per_stage=(128, 128, 64, 32),
            grid_pool_size=2, pool_approx_nsample=False,
            pool_layers=(
                m.PoolLayerConfig("x_conv2", (8, 8), (1, 1, 1), 1.0, 4),
                m.PoolLayerConfig("x_conv4", (8, 8), (1, 1, 1), 4.0, 4)))))
    stages = stages or ((1, 1e-3, "L_total"), (0, 3e-4, "L_total"))
    return dataclasses.replace(cfg, train=m.TrainConfig(
        batch_size=1, grad_accum_steps=grad_accum, log_every_steps=1,
        stages=tuple(m.StageConfig(*s) for s in stages)))


@pytest.fixture(scope="module")
def jrdb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jrdb"))
    write_synthetic_jrdb(root, num_seqs=1, frames_per_seq=3,
                         people_per_frame=4, image_hw=(48, 80))
    return root


def _log(workdir):
    with open(os.path.join(workdir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _snapshot(state: TrainState) -> dict:
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def _trained_state(seed, micro_steps, accum=2):
    cfg = dataclasses.replace(tiny_config(), train=dataclasses.replace(
        tiny_config().train, grad_accum_steps=accum))
    model = MGAR(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model.parameters(), cfg.train.stages[0], 8, accum,
                         cfg.train.lr_decay_gamma)
    step = make_train_step(model, opt, "L_total")
    batch = batch_from_numpy(synthetic_batch_numpy(cfg, batch_size=2))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0                    # so both continuations see one draw
    for _ in range(micro_steps):
        step(batch)
    return TrainState(model, opt, micro_steps), step, batch


def _printed_metrics(text: str, tag: str) -> dict:
    line = next(l for l in text.splitlines() if l.startswith(tag))
    return ast.literal_eval(line[len(tag):].strip())


def _thaw(tree):
    return {k: _thaw(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _final_state(cfg, workdir, **kw):
    """run_training on the CPU; the model's and the optimizer's tensors at
    the end of the last stage, and the global step."""
    end = {}
    run_training(cfg, workdir, max_steps_per_epoch=2, device="cpu",
                 on_stage_end=lambda i, s: end.update(_snapshot(s)), **kw)
    return end


def _assert_same_state(got, ref):
    assert got["step"] == ref["step"]
    assert list(got["model"]) == list(ref["model"])
    for k, v in ref["model"].items():
        assert torch.equal(got["model"][k], v), k
    for key in ("exp_avg", "exp_avg_sq", "acc"):
        for a, b in zip(got["optimizer"][key], ref["optimizer"][key]):
            assert torch.equal(a, b), key
    assert got["optimizer"]["updates"] == ref["optimizer"]["updates"]
