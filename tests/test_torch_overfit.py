"""The port learns: twins of the JAX package's two learning checks.

- tests/test_overfit.py: MGAR at tiny_config on a fixed learnable set,
  from the JAX test's own init (flax's init at PRNGKey(0), converted): the
  eval-mode L_total falls 10 times and the train-set grouping AP is 1;
- tests/test_detection_overfit.py: SECOND on one fixed scene, the loss
  falls 5 times in 200 steps and the top detection, scoring above 0.3,
  lies within 2 m (BEV) of a ground-truth centre.

Both are marked ``slow``, as their JAX originals are. chip_smoke.py phase
13g runs the same functions on the card, MGAR from the port's own init.
"""
import dataclasses

import jax
import numpy as np
import pytest

from multimodal_gar_tpu_torch.utils.testing import (learnable_batch,
                                                    overfit_mgar,
                                                    overfit_second)


@pytest.mark.slow
def test_overfit_fixed_set_group_ap_and_loss():
    from multimodal_gar_tpu.models import MGAR
    from multimodal_gar_tpu.train.train_state import create_train_state
    from tests.test_overfit import _learnable_batch
    from tests.util import tiny_config
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=1, lr_decay_gamma=1.0))
    stage = dataclasses.replace(cfg.train.stages[0], learning_rate=2e-3)
    batch = _learnable_batch(cfg)
    mine = learnable_batch(cfg)
    for f in dataclasses.fields(mine):
        got = getattr(mine, f.name)
        if isinstance(got, dict):
            continue                          # the rulebook: a copy's maps
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                getattr(batch, f.name)), err_msg=f.name)
    state, _ = create_train_state(cfg, MGAR(cfg), batch,
                                  jax.random.PRNGKey(0), stage,
                                  steps_per_epoch=1000)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    r = overfit_mgar(device="cpu", variables=variables)
    assert r["loss"] <= r["loss0"] / 10, r
    assert r["group_ap"] == pytest.approx(1.0, abs=1e-6), r


@pytest.mark.slow
def test_second_overfits_fixed_scene():
    r = overfit_second(device="cpu")
    assert np.isfinite(r["last"]), r
    assert r["last"] < r["first"] / 5.0, r
    assert r["top_to_gt_m"] < 2.0, r
    assert r["top_score"] > 0.3, r
