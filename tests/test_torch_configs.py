"""The whole MGAR of the port against the JAX MGAR for each shipped config
other than mil3 (configs/fusion_sum.yaml, fusion_concat.yaml,
fusion_cross_attention.yaml, rgb_baseline.yaml, lidar_baseline.yaml), the
file's model settings loaded over tiny_config: the eval forward's outputs
and one training micro-step's losses.

Same batch (numpy, seed 0, conditioned as the train-step parity test's),
same weights (numpy, through the converter). The JAX side runs on the CPU
as its own tests do (the XLA stem, exact top-k). Float outputs and losses
agree to 1e-4 of the largest reference value, group ids exactly; the
training forward runs with dropout off on both sides.
"""
import os

import flax.linen
import jax
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu.train import losses as jax_losses
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.train.losses import compute_losses, total_loss
from multimodal_gar_tpu_torch.train.train_state import make_eval_step
from multimodal_gar_tpu_torch.utils.testing import (
    batch_from_numpy, condition_for_grad_parity_, prepare_grad_parity_,
    synthetic_batch_numpy, tiny_config, with_model_of)
from tests.test_torch_common import (assert_close, exact_pool_config,
                                     jax_batch, port_module, random_variables,
                                     to_jax)

TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ("fusion_sum", "fusion_concat", "fusion_cross_attention",
           "rgb_baseline", "lidar_baseline")
FLOAT_FIELDS = ("a_theta", "card", "rgb_features", "lidar_features",
                "fused_features")
TUPLE_FIELDS = ("pose", "interaction", "sg_pose", "sg_interaction")


@pytest.fixture(scope="module", params=SHIPPED)
def run(request):
    path = os.path.join(ROOT, "configs", f"{request.param}.yaml")
    cfg = with_model_of(path, exact_pool_config(tiny_config()))
    fields = condition_for_grad_parity_(
        synthetic_batch_numpy(cfg, batch_size=2, seed=0))
    jb = jax_batch(fields)
    jmodel = JaxMGAR(cfg)
    variables = random_variables(jmodel, jb, train=False, seed=0)
    params = variables["params"]
    # a_theta on both sides of the decode threshold, clear of it (the
    # conditioned boxes overlap, so Dg is large: a negative bias)
    params["gar_fusion"]["D_embed"]["kernel"] = np.array([[1.0], [4.0]],
                                                         np.float32)
    params["gar_fusion"]["D_embed"]["bias"] = np.array([-1.7], np.float32)
    if "rgb_backbone" in params:          # as prepare_grad_parity_ sets it
        w_z = params["rgb_backbone"]["self_att"]["W_z"]
        w_z["bias"] = np.zeros_like(w_z["bias"])
    jv = to_jax(variables)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(jv, jb)

    def train_losses(v, b):
        out, _ = jmodel.apply(v, b, train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        losses = jax_losses.compute_losses(out, b)
        return losses, jax_losses.total_loss(losses, "L_total")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        ref_losses, ref_total = jax.jit(train_losses)(jv, jb)
    model = port_module(MGAR, cfg, variables=variables)
    return cfg, fields, model, ref, ref_losses, ref_total


def test_shipped_config_builds_only_its_backbones(run):
    cfg, _, model, ref, _, _ = run
    modality = cfg.model.fusion.modality
    assert (model.rgb_backbone is None) == (modality == "LiDAR")
    assert (model.lidar_backbone is None) == (modality == "RGB")
    assert (ref.rgb_features is None) == (modality == "LiDAR")


def test_shipped_config_eval_forward_matches_jax(run):
    _, fields, model, ref, _, _ = run
    got = make_eval_step(model)(batch_from_numpy(fields))
    for name in FLOAT_FIELDS:
        g, r = getattr(got, name), getattr(ref, name)
        if r is None:
            assert g is None, name
            continue
        assert_close(g, r, TOL, name)
    for name in TUPLE_FIELDS:
        for i, (g, r) in enumerate(zip(getattr(got, name),
                                       getattr(ref, name))):
            assert_close(g, r, TOL, f"{name}[{i}]")
    a = np.asarray(ref.a_theta)
    valid = fields["person_valid"]
    pair = valid[:, :, None] & valid[:, None, :] & ~np.eye(a.shape[-1],
                                                           dtype=bool)
    assert np.min(np.abs(a[pair] - 0.5)) > 1e-4
    assert np.any(a[pair] >= 0.5) and np.any(a[pair] < 0.5)
    np.testing.assert_array_equal(got.group_ids.numpy(),
                                  np.asarray(ref.group_ids))


def test_shipped_config_train_losses_match_jax(run):
    _, fields, model, _, ref_losses, ref_total = run
    state = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        prepare_grad_parity_(model).train()
        batch = batch_from_numpy(fields)
        with torch.no_grad():
            losses = compute_losses(model(batch), batch)
        assert set(losses) == set(ref_losses)
        for name, v in ref_losses.items():
            assert_close(losses[name].item(), float(v), TOL, name)
        assert_close(total_loss(losses, "L_total").item(), float(ref_total),
                     TOL, "L_total")
    finally:
        model.load_state_dict(state)         # the BN statistics moved
        model.eval()
