"""The port's checkpoints: a bit-exact save / restore, the manager's
rules, resuming a cut run, and the JAX optimizer state carried over
(helpers: tests/test_torch_loop_common.py)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import multimodal_gar_tpu.config as jax_config
import multimodal_gar_tpu_torch.config as port_config
from multimodal_gar_tpu.train.train_state import (make_optimizer as
                                                  jax_make_optimizer)
from multimodal_gar_tpu_torch.convert import (convert_optimizer_state,
                                              load_jax_variables)
from multimodal_gar_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_gar_tpu_torch.train.loop import run_training
from multimodal_gar_tpu_torch.train.train_state import (TrainState,
                                                        make_optimizer)
from tests.test_torch_common import assert_close
from tests.test_torch_loop_common import (tiny_training_cfg, jrdb_root, _log,
                                          _trained_state, _thaw)


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
