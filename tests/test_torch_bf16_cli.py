"""``python -m multimodal_gar_tpu_torch eval --set model.dtype=bfloat16``
and ``train`` at bf16, through ``main`` on the CPU, on the tiny on-disk
synthetic JRDB of tests/test_torch_loop_common.py.

A float32 checkpoint of the seeded model is served at bf16 (parameters
stay float32, so the state dict is the same): the evaluation runs, writes
its results and gives the float32 evaluation's metric names, each finite.
Training at bf16 runs, and its checkpoint holds float32 parameters, which
``eval`` serves at either dtype.
"""
import json
import math
import os

import pytest
import torch
import yaml

import multimodal_gar_tpu_torch.config as port_config
from multimodal_gar_tpu_torch.__main__ import main
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_gar_tpu_torch.train.train_state import (TrainState,
                                                        make_optimizer)
from tests.test_torch_loop_common import (_printed_metrics, jrdb_root,
                                          tiny_training_cfg)


@pytest.fixture(scope="module")
def workdir(jrdb_root, tmp_path_factory):
    """A config file and a workdir holding one float32 checkpoint."""
    root = tmp_path_factory.mktemp("bf16_cli")
    cfg = tiny_training_cfg(port_config, jrdb_root)
    path = str(root / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(
            port_config.config_to_dict(cfg))), f)
    model = MGAR(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(cfg.train.seed))
    opt = make_optimizer(model.parameters(), cfg.train.stages[0], 1, 1, 0.1)
    work = str(root / "work")
    CheckpointManager(os.path.join(work, "checkpoints")).save(
        0, TrainState(model=model, optimizer=opt))
    return path, work


def test_cli_eval_serves_a_float32_checkpoint_at_bf16(workdir, capsys):
    path, work = workdir
    common = ["--config", path, "--workdir", work, "--device", "cpu"]
    assert main(["eval", *common]) == 0
    f32 = _printed_metrics(capsys.readouterr().out, "eval:")
    assert main(["eval", *common, "--set", "model.dtype=bfloat16"]) == 0
    bf16 = _printed_metrics(capsys.readouterr().out, "eval:")
    assert set(bf16) == set(f32)
    assert all(math.isfinite(v) for v in bf16.values())
    assert os.path.exists(os.path.join(work, "results", "eval",
                                       "grouping.txt"))


def test_cli_train_at_bf16_raises(workdir, capsys):
    """(Its name from when bf16 training raised.) ``train --set
    model.dtype=bfloat16`` trains the tiny config's stages on the CPU and
    writes a checkpoint of float32 parameters; ``eval`` serves it at both
    dtypes, every metric finite."""
    path, work = workdir
    out = work + "_train"
    assert main(["train", "--config", path, "--workdir", out, "--set",
                 "model.dtype=bfloat16", "--device", "cpu"]) == 0
    ckpts = [n for n in os.listdir(os.path.join(out, "checkpoints"))
             if n.endswith(".pt")]
    assert ckpts, "no checkpoint written"
    state = torch.load(os.path.join(out, "checkpoints", sorted(ckpts)[-1]),
                       map_location="cpu", weights_only=False)
    params = state["model"] if "model" in state else state
    floats = [v for v in params.values() if torch.is_tensor(v)
              and v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)
    capsys.readouterr()
    for over in ([], ["--set", "model.dtype=bfloat16"]):
        assert main(["eval", "--config", path, "--workdir", out,
                     "--device", "cpu", *over]) == 0
        metrics = _printed_metrics(capsys.readouterr().out, "eval:")
        assert metrics and all(math.isfinite(v) for v in metrics.values())
