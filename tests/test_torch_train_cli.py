"""The port's CLI, and the port's training loop against the JAX
package's at the tiny config of tests/test_train_loop.py, on
``device="cpu"`` (helpers: tests/test_torch_loop_common.py).

Against JAX (``test_two_steps_through_both_loops``): both loops start from
the same weights (the JAX run's initial variables through the converter),
read the same on-disk synthetic JRDB in the same order, run with dropout
off and ``grad_accum_steps`` 1 for two steps, and end with weights within
1e-4 of each other (the tolerance of tests/test_torch_train_step.py).

Adam's first update is ``lr * sign(g)`` for every element, however small
its gradient, so where two float32 implementations disagree on the sign of
a noise-level gradient the weights part by ``2 * lr``: at the stage's usual
1e-3 that is 4e-3 after two steps, measured on up to a sixth of the
elements of the attention matrices, whatever the implementation. The
comparison therefore runs at a learning rate of 1e-6, which keeps that
noise under the tolerance, and carries its weight in what Adam does not
normalise: the logged losses of both steps (1e-4), the BatchNorm statistics
(1e-4) and the Adam moments after the second step, read from the JAX
optimizer state through ``convert_optimizer_state`` (first moment 5e-4 and
second moment 1e-3 of each leaf's largest value: second-step gradients
through first-step weights, float32 sums in other orders). The biases whose
gradient is zero in exact arithmetic (utils/testing.py:
BN_CANCELLED_BIASES) are held as noise on both sides (under 1e-3 of the
largest moment of any leaf).
"""
import dataclasses
import json
import os

import flax.linen
import jax
import numpy as np
import pytest
import torch
import yaml

import multimodal_gar_tpu.config as jax_config
import multimodal_gar_tpu_torch.config as port_config
from multimodal_gar_tpu.train.loop import run_training as jax_run_training
from multimodal_gar_tpu_torch.__main__ import main
from multimodal_gar_tpu_torch.convert import (_flatten, _target,
                                              convert_optimizer_state,
                                              load_jax_variables)
from multimodal_gar_tpu_torch.train.loop import run_eval, run_training
from multimodal_gar_tpu_torch.utils.testing import BN_CANCELLED_BIASES
from tests.test_torch_common import assert_close
from tests.test_torch_loop_common import (tiny_training_cfg, jrdb_root, _log,
                                          _snapshot, _printed_metrics, _thaw)

WEIGHT_TOL = 1e-4           # absolute: "within 1e-4 of each other"
LOSS_TOL = 1e-4
STATS_TOL = 1e-4
MU_TOL, NU_TOL = 5e-4, 1e-3
NOISE_TOL = 1e-3
PARITY_LR = 1e-6


def test_cli_train_then_eval(jrdb_root, tmp_path, capsys):
    """``python -m multimodal_gar_tpu_torch train`` then ``eval`` on the
    same workdir, through ``main``: the evaluation of the restored
    checkpoint gives the training run's last metrics, exactly."""
    cfg = tiny_training_cfg(port_config, jrdb_root)
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(
            port_config.config_to_dict(cfg))), f)
    assert dataclasses.asdict(port_config.load_config(path)) \
        == dataclasses.asdict(cfg)
    workdir = str(tmp_path / "cli")
    common = ["--config", path, "--workdir", workdir,
              "--set", "train.log_every_steps=2"]
    assert main(["train", *common, "--max-steps-per-epoch", "2",
                 "--device", "cpu"]) == 0
    trained = _printed_metrics(capsys.readouterr().out, "final:")
    assert [r["step"] for r in _log(workdir) if "train/loss" in r] == [2]
    assert main(["eval", *common, "--device", "cpu"]) == 0
    evaluated = _printed_metrics(capsys.readouterr().out, "eval:")
    assert set(evaluated) == set(trained) - {"score"}
    for k, v in evaluated.items():
        assert v == trained[k], k
    assert os.path.exists(os.path.join(workdir, "results", "eval",
                                       "grouping.txt"))
    assert run_eval(port_config.load_config(path), workdir,
                    device="cpu") == evaluated


def test_two_steps_through_both_loops(jrdb_root, tmp_path):
    stages = ((1, PARITY_LR, "L_total"),)
    snaps = {}

    def jax_hook(name):
        return lambda i, s: snaps.update({name: jax.device_get(s)})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        ref_metrics = jax_run_training(
            tiny_training_cfg(jax_config, jrdb_root, stages),
            str(tmp_path / "jax"), use_mesh=False, max_steps_per_epoch=2,
            resume=False, on_stage_start=jax_hook("start"),
            on_stage_end=jax_hook("end"))

    def start(_, state):
        load_jax_variables(state.model, {
            "params": _thaw(snaps["start"].params),
            "batch_stats": _thaw(snaps["start"].batch_stats)})
        for m in state.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0

    got = {}
    metrics = run_training(
        tiny_training_cfg(port_config, jrdb_root, stages),
        str(tmp_path / "port"), max_steps_per_epoch=2, resume=False,
        device="cpu", on_stage_start=start,
        on_stage_end=lambda i, s: got.update(_snapshot(s), live=s))

    # the two logged steps
    ref_rows = [r for r in _log(str(tmp_path / "jax")) if "train/loss" in r]
    rows = [r for r in _log(str(tmp_path / "port")) if "train/loss" in r]
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows] == [1, 2]
    for r, ref in zip(rows, ref_rows):
        for k, v in ref.items():
            if k.startswith("train/"):
                assert abs(r[k] - v) <= LOSS_TOL * max(abs(v), 1.0), (k, r, ref)

    # weights and BatchNorm statistics at the end
    end = snaps["end"]
    moved = 0
    for col, tree, tol in (("params", end.params, None),
                           ("batch_stats", end.batch_stats, STATS_TOL)):
        first = dict(_target(col, p, l) for p, l in _flatten(_thaw(
            getattr(snaps["start"], col))))
        for path, leaf in _flatten(_thaw(tree)):
            key, ref = _target(col, path, leaf)
            val = got["model"][key].numpy()
            if tol is None:
                assert np.abs(val - ref).max() <= WEIGHT_TOL, key
                moved += int(not np.array_equal(ref, first[key]))
            else:
                assert_close(val, ref, tol, key)
    assert moved > 100                    # the loops did train

    # the Adam moments, through the optimizer-state converter
    adam = end.opt_state[0]
    assert int(adam.count) == 2 and got["optimizer"]["updates"] == 2
    ref_opt = convert_optimizer_state(
        got["live"].model, _thaw(adam.mu), _thaw(adam.nu), int(adam.count))
    names = [n for n, p in got["live"].model.named_parameters()
             if p.requires_grad]
    # noise is held against the largest moment of any leaf: with flax's
    # zero-initialised W_z_bn scale the noisy biases' own layers have next
    # to no gradient either
    largest = {key: max(t.abs().max() for t in ref_opt[key])
               for key in ("exp_avg", "exp_avg_sq")}
    checked = 0
    for i, name in enumerate(names):
        for key, tol in (("exp_avg", MU_TOL), ("exp_avg_sq", NU_TOL)):
            val, ref = got["optimizer"][key][i], ref_opt[key][i]
            if name in BN_CANCELLED_BIASES:
                for side in (val, ref):
                    assert side.abs().max() <= NOISE_TOL * largest[key], \
                        (name, key)
                continue
            if not ref.any():
                assert not val.any(), (name, key)   # card_net: no gradient
                continue
            assert_close(val.numpy(), ref.numpy(), tol, f"{name} {key}")
            checked += 1
    assert checked > 300

    # and what the run reports
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        assert abs(metrics[k] - v) <= 1e-6, (k, metrics[k], v)
