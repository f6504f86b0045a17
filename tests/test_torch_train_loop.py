"""The port's training loop, checkpoints and CLI at the tiny config of
tests/test_train_loop.py, on ``device="cpu"``, and against the JAX
package's loop.

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
import ast
import dataclasses
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import multimodal_gar_tpu.config as jax_config
import multimodal_gar_tpu_torch.config as port_config
from multimodal_gar_tpu.data.synthetic import write_synthetic_jrdb
from multimodal_gar_tpu.train.loop import run_training as jax_run_training
from multimodal_gar_tpu.train.train_state import (
    make_optimizer as jax_make_optimizer)
from multimodal_gar_tpu_torch.__main__ import main
from multimodal_gar_tpu_torch.convert import (_flatten, _target,
                                              convert_optimizer_state,
                                              load_jax_variables)
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_gar_tpu_torch.train.loop import run_eval, run_training
from multimodal_gar_tpu_torch.train.train_state import (TrainState,
                                                        make_optimizer,
                                                        make_train_step)
from multimodal_gar_tpu_torch.utils.testing import (BN_CANCELLED_BIASES,
                                                    batch_from_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import assert_close

WEIGHT_TOL = 1e-4           # absolute: "within 1e-4 of each other"
LOSS_TOL = 1e-4
STATS_TOL = 1e-4
MU_TOL, NU_TOL = 5e-4, 1e-3
NOISE_TOL = 1e-3
PARITY_LR = 1e-6


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


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """save -> restore into a differently seeded model and a fresh
    optimizer: weights, BatchNorm statistics, Adam moments, the accumulator
    and the counts come back bit for bit, and one more micro-step (which
    completes an accumulation and applies an update) gives the same
    weights."""
    state, step, batch = _trained_state(seed=0, micro_steps=3)
    assert state.optimizer.updates == 1 and state.optimizer.mini_step == 1
    assert any(a.any() for a in state.optimizer.acc)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(3, state, {"score": 0.5})
    other, other_step, _ = _trained_state(seed=1, micro_steps=0)
    assert not torch.equal(
        other.model.gar_fusion.D_embed.weight,
        state.model.gar_fusion.D_embed.weight)
    restored = ckpt.restore(other)
    assert restored.step == 3
    ref, got = state.model.state_dict(), other.model.state_dict()
    assert list(ref) == list(got)
    assert any(k.endswith("running_var") for k in ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    ref_o, got_o = state.optimizer.state_dict(), other.optimizer.state_dict()
    assert (got_o["mini_step"], got_o["updates"]) == (1, 1)
    for key in ("exp_avg", "exp_avg_sq", "acc"):
        assert len(ref_o[key]) == len(got_o[key]) > 100
        for a, b in zip(ref_o[key], got_o[key]):
            assert torch.equal(a, b), key
    step(batch)
    other_step(batch)
    assert state.optimizer.updates == other.optimizer.updates == 2
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_manager_rules(tmp_path):
    """max_to_keep = 3, best.json follows the best score only, restore of
    an empty directory raises."""
    state, _, _ = _trained_state(seed=0, micro_steps=0)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() is None and ckpt.best_info() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    for step, score in ((1, 0.2), (2, 0.6), (3, 0.4), (4, 0.5)):
        ckpt.save(step, state, {"score": score, "overall_AP": score})
    assert ckpt.all_steps() == [2, 3, 4] and ckpt.latest_step() == 4
    assert ckpt.best_info() == {"step": 2, "score": 0.6, "overall_AP": 0.6}
    ckpt.save(5, state)                          # no metrics: best unchanged
    assert ckpt.best_info()["step"] == 2
    assert ckpt.restore(TrainState(state.model, None), step=3).step == 3
    ckpt.close()


def test_resume_trains_no_epoch_twice(jrdb_root, tmp_path):
    """A run cut after epoch 0 of a 2-epoch stage goes on with epoch 1; a
    run resumed after the last epoch trains nothing."""
    workdir = str(tmp_path / "resume")
    one = tiny_training_cfg(port_config, jrdb_root,
                            stages=((1, 1e-3, "L_total"),))
    two = tiny_training_cfg(port_config, jrdb_root,
                            stages=((2, 1e-3, "L_total"),))
    run_training(one, workdir, max_steps_per_epoch=2, device="cpu")
    seen = {}
    metrics = run_training(
        two, workdir, max_steps_per_epoch=2, device="cpu",
        on_stage_start=lambda i, s: seen.update(
            start=s.step, updates=s.optimizer.updates),
        on_stage_end=lambda i, s: seen.update(end=s.step))
    assert seen == {"start": 2, "updates": 2, "end": 4}
    assert np.isfinite(metrics["score"])
    steps = [r["step"] for r in _log(workdir) if "train/loss" in r]
    assert steps == [1, 2, 3, 4]
    assert os.path.exists(os.path.join(workdir, "results", "s0_e1",
                                       "grouping.txt"))
    assert run_training(two, workdir, max_steps_per_epoch=2,
                        device="cpu") == {}
    assert [r["step"] for r in _log(workdir)
            if "train/loss" in r] == [1, 2, 3, 4]
    # resume=False starts over in the same workdir
    seen.clear()
    run_training(one, workdir, max_steps_per_epoch=1, resume=False,
                 device="cpu",
                 on_stage_start=lambda i, s: seen.update(start=s.step))
    assert seen == {"start": 0}


def _printed_metrics(text: str, tag: str) -> dict:
    line = next(l for l in text.splitlines() if l.startswith(tag))
    return ast.literal_eval(line[len(tag):].strip())


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


def _thaw(tree):
    return {k: _thaw(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


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


def test_convert_optimizer_state_with_accumulation():
    """optax.MultiSteps(adam) after 3 micro-steps at accumulation 2 (one
    update applied, one gradient in the accumulator) -> the port's
    optimizer: the 4th micro-step then applies the same update (1e-6)."""
    rng = np.random.default_rng(0)
    lin = torch.nn.Linear(4, 3)
    model = torch.nn.Module()
    model.a = lin
    init = {"a": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)}}
    load_jax_variables(model, {"params": init})
    stage = jax_config.StageConfig(epochs=1, learning_rate=1e-3,
                                   loss="L_total")
    tx = jax_make_optimizer(stage, steps_per_epoch=4, grad_accum=2, gamma=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = tx.init(jp)
    seq = [{"a": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)}}
           for _ in range(4)]
    for g in seq[:3]:
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
    load_jax_variables(model, {"params": _thaw(jp)})
    adam = opt_state.inner_opt_state[0]
    opt = make_optimizer(model.parameters(), stage, 4, 2, 0.5)
    opt.load_state_dict(convert_optimizer_state(
        model, _thaw(adam.mu), _thaw(adam.nu),
        int(opt_state.gradient_step), _thaw(opt_state.acc_grads),
        int(opt_state.mini_step)))
    assert (opt.updates, opt.mini_step) == (1, 1)
    updates, opt_state = tx.update(
        jax.tree_util.tree_map(jnp.asarray, seq[3]), opt_state, jp)
    jp = optax.apply_updates(jp, updates)
    g = seq[3]["a"]
    assert opt.update([torch.from_numpy(g["kernel"].T.copy()),
                       torch.from_numpy(g["bias"])])
    assert_close(lin.weight.detach().numpy(), np.asarray(jp["a"]["kernel"]).T,
                 1e-6, "kernel")
    assert_close(lin.bias.detach().numpy(), np.asarray(jp["a"]["bias"]),
                 1e-6, "bias")
    with pytest.raises(KeyError):
        convert_optimizer_state(model, {"a": {"bias": g["bias"]}},
                                _thaw(adam.nu), 1)


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


@pytest.fixture(scope="module")
def two_epochs(jrdb_root, tmp_path_factory):
    """An uninterrupted seeded run of two epochs, dropout on."""
    cfg = tiny_training_cfg(port_config, jrdb_root,
                            stages=((2, 1e-3, "L_total"),))
    return cfg, _final_state(cfg, str(tmp_path_factory.mktemp("whole")),
                             resume=False)


def test_two_seeded_runs_end_in_equal_weights(two_epochs, tmp_path):
    """Dropout draws under (train.seed, step) on the model's own generator:
    a second run of the same config ends bit for bit where the first did,
    whatever the global stream holds."""
    cfg, ref = two_epochs
    assert ref["step"] == 4
    assert any(isinstance(m, torch.nn.Dropout) and m.p > 0
               for m in MGAR(cfg, device="cpu").modules())
    torch.manual_seed(12345)                    # the caller's stream: unused
    _assert_same_state(_final_state(cfg, str(tmp_path / "again"),
                                    resume=False), ref)


def test_a_resumed_run_equals_the_uninterrupted_one(two_epochs, tmp_path,
                                                    jrdb_root):
    cfg, ref = two_epochs
    workdir = str(tmp_path / "cut")
    one = tiny_training_cfg(port_config, jrdb_root,
                            stages=((1, 1e-3, "L_total"),))
    cut = _final_state(one, workdir, resume=False)
    assert cut["step"] == 2
    assert any(not torch.equal(v, ref["model"][k])
               for k, v in cut["model"].items())
    _assert_same_state(_final_state(cfg, workdir, resume=True), ref)


def test_dropout_follows_seed_and_step_not_the_global_stream():
    from multimodal_gar_tpu_torch.models.layers import seed_dropout
    cfg = tiny_config()
    model = MGAR(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.train()
    drop = model.gar_fusion.pose_head_1.dropout
    x = torch.ones((64, 512))

    def mask(seed, step):
        seed_dropout(model, seed, step)
        return drop(x) != 0

    torch.manual_seed(7)
    before = torch.get_rng_state()
    a = mask(2023, 5)
    assert 0.15 < 1 - a.float().mean().item() < 0.25
    assert torch.equal(mask(2023, 5), a)
    assert not torch.equal(mask(2023, 6), a)
    assert not torch.equal(mask(2024, 5), a)
    assert torch.equal(torch.get_rng_state(), before)
    # every dropout of the model shares the one generator
    gens = {id(m.generator) for m in model.modules()
            if isinstance(m, torch.nn.Dropout)}
    assert len(gens) == 1 and None not in {
        m.generator for m in model.modules()
        if isinstance(m, torch.nn.Dropout)}


def test_a_train_step_leaves_the_global_rng_state_alone():
    """The step follows the TrainState's step; two steps of one state draw
    different masks, and a second state at the same step the same."""
    cfg = tiny_config()
    batch = batch_from_numpy(synthetic_batch_numpy(cfg, batch_size=2))
    losses = []
    for _ in range(2):
        model = MGAR(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(model.parameters(), cfg.train.stages[0], 8, 4,
                             cfg.train.lr_decay_gamma)
        state = TrainState(model, opt, step=3)
        step = make_train_step(model, opt, "L_total", state=state, seed=11)
        torch.manual_seed(len(losses))          # differs between the two
        before = torch.get_rng_state()
        first = step(batch)["loss"].item()
        state.step = 4
        second = step(batch)["loss"].item()
        assert torch.equal(torch.get_rng_state(), before)
        losses.append((first, second))
    assert losses[0] == losses[1]
    assert losses[0][0] != losses[0][1]


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
