"""Seeded runs of the port's loop repeat bit for bit: dropout follows
(seed, step) on the model's own generator, never the global stream, and a
cut and resumed run ends where the uninterrupted one does (helpers:
tests/test_torch_loop_common.py)."""
import pytest
import torch

import multimodal_gar_tpu_torch.config as port_config
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.train.train_state import (TrainState,
                                                        make_optimizer,
                                                        make_train_step)
from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_loop_common import (tiny_training_cfg, jrdb_root,
                                          _final_state, _assert_same_state)


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
