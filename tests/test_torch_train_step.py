"""The port's train step against the JAX package's at tiny_config.

Same synthetic batch (numpy, seed 0) and randomised weights (numpy, through
the converter); dropout off on both sides (the two RNGs cannot match): the
port's ``nn.Dropout`` modules get p = 0, and the JAX side runs with a
test-local identity in place of ``flax.linen.Dropout.__call__``.

- Loss of one training forward to 1e-5 relative, and every parameter's
  gradient to 1e-4 of that leaf's largest |gradient| (float32 sums in other
  orders through the backward of ~20 layers); the frozen I3D gets no
  gradient in the port and exactly zero in JAX. The batch and weights are
  conditioned as utils/testing.py's ``condition_for_grad_parity_`` and
  ``prepare_grad_parity_`` describe.
- The BatchNorm running statistics of that forward to 1e-5.
- The optimizer against optax on one numpy gradient sequence to 1e-6.
- The non-finite guard, as tests/test_train_step.py:91-103 checks it.
"""
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodal_gar_tpu.config import StageConfig
from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu.train import losses as jax_losses
from multimodal_gar_tpu.train.train_state import (
    make_optimizer as jax_make_optimizer)
from multimodal_gar_tpu_torch.convert import _target
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.models.sparse_backbone import (
    _LAYERS as SPARSE_LAYERS)
from multimodal_gar_tpu_torch.train.losses import compute_losses, total_loss
from multimodal_gar_tpu_torch.train.train_state import (make_optimizer,
                                                        make_train_step)
from multimodal_gar_tpu_torch.utils.testing import (
    BN_CANCELLED_BIASES, batch_from_numpy, condition_for_grad_parity_,
    prepare_grad_parity_, synthetic_batch_numpy, tiny_config)
from tests.test_torch_common import (assert_close, exact_pool_config,
                                     jax_batch, port_module, random_variables,
                                     to_jax)

GRAD_TOL = 1e-4
# the gradients of BN_CANCELLED_BIASES are zero in exact arithmetic and
# rounding noise on both sides (~1e-4 of their layer's weight gradient):
# both sides are held below NOISE_TOL of that weight gradient, as noise
# against noise has no relative error to check
NOISE_TOL = 1e-3
LOSS_TOL = 1e-5
STATS_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    cfg = exact_pool_config(tiny_config())
    fields = condition_for_grad_parity_(
        synthetic_batch_numpy(cfg, batch_size=2, seed=0))
    jb = jax_batch(fields)
    jmodel = JaxMGAR(cfg)
    variables = random_variables(jmodel, jb, train=False, seed=0)
    # a_theta clear of the 0.5 group-decode threshold, on both sides of it
    # (as tests/test_torch_slice.py sets it)
    d_embed = variables["params"]["gar_fusion"]["D_embed"]
    d_embed["kernel"] = np.array([[1.0], [4.0]], np.float32)
    d_embed["bias"] = np.array([0.3], np.float32)
    # as prepare_grad_parity_ sets the port's: the RGB non-local W_z bias 0
    w_z = variables["params"]["rgb_backbone"]["self_att"]["W_z"]
    w_z["bias"] = np.zeros_like(w_z["bias"])

    def loss_fn(params, batch_stats):
        out, updates = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, jb, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        losses = jax_losses.compute_losses(out, jb)
        return (jax_losses.total_loss(losses, "L_total"),
                (losses, updates["batch_stats"]))

    jv = to_jax(variables)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        (loss, (losses, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jv["params"], jv["batch_stats"])
    return cfg, fields, variables, loss, losses, stats, grads


def _port_train_forward(setup):
    cfg, fields, variables = setup[:3]
    model = prepare_grad_parity_(port_module(MGAR, cfg,
                                             variables=variables)).train()
    batch = batch_from_numpy(fields)
    losses = compute_losses(model(batch), batch)
    return model, losses, total_loss(losses, "L_total")


def test_train_loss_and_gradients_match_jax(setup):
    _, _, _, ref_loss, ref_losses, _, ref_grads = setup
    model, losses, loss = _port_train_forward(setup)
    assert_close(loss.item(), float(ref_loss), LOSS_TOL, "loss")
    for name, v in ref_losses.items():
        assert_close(losses[name].item(), float(v), LOSS_TOL, name)
    params = dict(model.named_parameters())
    trainable = [k for k, p in params.items() if p.requires_grad]
    # L_total leaves card_net out: its gradient is None here, zeros in JAX
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(trainable, torch.autograd.grad(
                 loss, [params[k] for k in trainable], allow_unused=True))}
    refs = dict(_target("params", path, np.asarray(g))
                for path, g in flatten_dict(ref_grads).items())
    seen = set()
    for key, ref in refs.items():
        if key.startswith("rgb_backbone.i3d."):
            assert not params[key].requires_grad, key
            assert not np.any(ref), f"{key}: JAX's frozen I3D has a gradient"
            continue
        got = grads[key].numpy()
        if key in BN_CANCELLED_BIASES:
            scale = np.abs(refs[key.replace(".bias", ".weight")]).max()
            for side in (got, ref):
                assert np.abs(side).max() <= NOISE_TOL * scale, key
        else:
            assert_close(got, ref, GRAD_TOL, key)
        seen.add(key)
    assert seen == set(trainable)
    for name, _, _, _, _ in SPARSE_LAYERS:
        g = grads[f"lidar_backbone.backbone3d.{name}.conv.weight"]
        assert torch.count_nonzero(g) > 0, name


def test_train_batch_stats_match_jax(setup):
    _, _, _, _, _, ref_stats, _ = setup
    model, _, _ = _port_train_forward(setup)
    state = model.state_dict()
    flat = flatten_dict(jax.tree_util.tree_map(np.asarray, ref_stats))
    assert len(flat) > 0
    for path, v in flat.items():
        key, ref = _target("batch_stats", path, v)
        assert_close(state[key].numpy(), ref, STATS_TOL, key)


def test_optimizer_matches_optax():
    """3 updates at grad_accum 2 on one numpy gradient sequence, with the
    decay stepping once (steps_per_epoch 4: transition every 2 updates)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    seq = [{k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()} for _ in range(6)]
    stage = StageConfig(epochs=1, learning_rate=1e-3, loss="L_total")
    tx = jax_make_optimizer(stage, steps_per_epoch=4, grad_accum=2,
                            gamma=0.5)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = make_optimizer(list(params.values()), stage, steps_per_epoch=4,
                         grad_accum=2, gamma=0.5)
    tx_update = jax.jit(tx.update)
    for i, g in enumerate(seq):
        updates, opt_state = tx_update({k: jnp.asarray(v)
                                        for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        applied = opt.update([torch.from_numpy(g[k]) for k in params])
        assert applied == (i % 2 == 1)
        for k in params:
            assert_close(params[k].detach().numpy(), np.asarray(jp[k]),
                         1e-6, f"{k} after micro-step {i}")
    assert opt.updates == 3 and opt.learning_rate == pytest.approx(5e-4)


def test_nonfinite_grad_guard():
    """A poisoned batch (NaN images) must not corrupt the parameters."""
    cfg = dataclasses.replace(tiny_config(), train=dataclasses.replace(
        tiny_config().train, grad_accum_steps=2))
    model = MGAR(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), cfg.train.stages[0], 4,
                         cfg.train.grad_accum_steps, cfg.train.lr_decay_gamma)
    step = make_train_step(model, opt, "L_total")
    batch = batch_from_numpy(synthetic_batch_numpy(cfg, batch_size=2))
    bad = dataclasses.replace(batch, images=batch.images * float("nan"))
    p0 = [p.detach().clone() for p in opt.params]
    m1 = step(bad)
    m2 = step(bad)                            # completes the accumulation
    assert float(m1["nonfinite_grads"]) == 1.0
    assert float(m2["nonfinite_grads"]) == 1.0 and opt.updates == 1
    for p, q in zip(opt.params, p0):
        assert torch.isfinite(p).all()
        torch.testing.assert_close(p.detach(), q, rtol=0, atol=0)


def test_dropout_is_active_in_training_only():
    """The heads' Dropout(0.2): identity in eval; in training it zeroes
    about a fifth of the units and scales the rest by 1 / (1 - p)."""
    from multimodal_gar_tpu_torch.models.layers import HeadMLP
    head = HeadMLP(16, 512, 4, "sigmoid", device="cpu",
                   generator=torch.Generator().manual_seed(0))
    x = torch.ones((64, 512))
    drop = head.dropout
    assert drop.p == pytest.approx(0.2)
    head.eval()
    assert torch.equal(drop(x), x)
    head.train()
    torch.manual_seed(0)
    y = drop(x)
    kept = y != 0
    assert 0.15 < 1 - kept.float().mean().item() < 0.25
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
