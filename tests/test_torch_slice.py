"""The port's whole MGAR eval forward against the JAX MGAR at tiny_config.

Same synthetic batch (numpy, seed 0), same randomised weights (numpy,
through the converter). The JAX side runs on the CPU as the JAX tests do:
the XLA stem (Pallas is gated to the TPU) and exact top-k neighbour
selection, which is the port's. Float outputs agree to 1e-4 relative to the
largest reference value: both sides are float32 with sums in other orders,
through ~20 layers. The group decode is a 0.5 threshold on a_theta, so
group_ids must be exactly equal once every valid pair is clear of it. The
same holds with ``x_window`` off, where the sparse convs run the nbr-map
path (the subm_conv wrapper) on both sides.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.train.train_state import make_eval_step
from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import (assert_close, exact_pool_config,
                                     jax_batch, port_module, random_variables,
                                     to_jax)

TOL = 1e-4
FLOAT_FIELDS = ("a_theta", "card", "rgb_features", "lidar_features",
                "fused_features")
TUPLE_FIELDS = ("pose", "interaction", "sg_pose", "sg_interaction")


def _run(cfg):
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    jb = jax_batch(fields)
    jmodel = JaxMGAR(cfg)
    variables = random_variables(jmodel, jb, train=False, seed=0)
    # random D_embed draws leave every pair of this scene on one side of the
    # 0.5 threshold; these weights put a_theta on both sides, well clear of
    # it, so that the group decode is exercised
    d_embed = variables["params"]["gar_fusion"]["D_embed"]
    d_embed["kernel"] = np.array([[1.0], [4.0]], np.float32)
    d_embed["bias"] = np.array([0.3], np.float32)
    ref = jax.jit(partial(jmodel.apply, train=False))(to_jax(variables), jb)
    model = port_module(MGAR, cfg, variables=variables)
    got = make_eval_step(model)(batch_from_numpy(fields))
    return ref, got, fields


@pytest.fixture(scope="module")
def outputs():
    return _run(exact_pool_config(tiny_config()))


def test_slice_float_outputs_match_jax(outputs):
    ref, got, _ = outputs
    for name in FLOAT_FIELDS:
        assert_close(getattr(got, name), getattr(ref, name), TOL, name)
    for name in TUPLE_FIELDS:
        refs, gots = getattr(ref, name), getattr(got, name)
        assert len(refs) == len(gots)
        for i, (g, r) in enumerate(zip(gots, refs)):
            assert_close(g, r, TOL, f"{name}[{i}]")


def test_slice_nbr_map_path_matches_jax():
    import dataclasses
    cfg = exact_pool_config(tiny_config())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lidar=dataclasses.replace(cfg.model.lidar,
                                             x_window=False)))
    ref, got, _ = _run(cfg)
    for name in FLOAT_FIELDS:
        assert_close(getattr(got, name), getattr(ref, name), TOL, name)
    for name in TUPLE_FIELDS:
        for i, (g, r) in enumerate(zip(getattr(got, name),
                                       getattr(ref, name))):
            assert_close(g, r, TOL, f"{name}[{i}]")
    np.testing.assert_array_equal(got.group_ids.numpy(),
                                  np.asarray(ref.group_ids))


def test_slice_group_ids_match_jax_exactly(outputs):
    ref, got, fields = outputs
    a = np.asarray(ref.a_theta)
    valid = fields["person_valid"]
    pair = valid[:, :, None] & valid[:, None, :] & ~np.eye(a.shape[-1],
                                                           dtype=bool)
    # a draw within 1e-4 of the threshold would make the check flaky
    assert np.min(np.abs(a[pair] - 0.5)) > 1e-4
    np.testing.assert_array_equal(got.group_ids.numpy(),
                                  np.asarray(ref.group_ids))
    # the fixture exercises real grouping: some valid pair is linked
    assert np.any(a[pair] >= 0.5) and np.any(a[pair] < 0.5)


def test_slice_masks_padded_actors(outputs):
    _, got, fields = outputs
    invalid = torch.from_numpy(~fields["person_valid"])
    valid = ~invalid
    for p in got.pose:
        assert torch.all(p[invalid] == 0)
        torch.testing.assert_close(p[valid].sum(-1),
                                   torch.ones(int(valid.sum())))
    assert torch.all(got.a_theta[invalid] == 0)
    diag = torch.diagonal(got.a_theta, dim1=1, dim2=2)
    assert torch.all(diag[valid] == 1)


def test_tpu_workaround_flags_leave_the_port_unchanged():
    """The shared config keeps the JAX package's TPU workaround keys; the
    port ignores them, so flipping them changes neither weights nor
    outputs."""
    import dataclasses
    cfg = tiny_config()
    rgb = dataclasses.replace(
        cfg.model.rgb, pallas_stem=False, pallas_stem_passes=3,
        pallas_stem_dimajor=True, pallas_stem_cmajor=True,
        pallas_stem_pipelined=False, i3d_t2d=True, i3d_bf16_body=True,
        i3d_batch_unroll=False)
    lidar = dataclasses.replace(cfg.model.lidar, x_window_fused=True)
    flipped = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rgb=rgb, lidar=lidar))
    batch = batch_from_numpy(synthetic_batch_numpy(cfg, batch_size=1))
    outs = []
    for c in (cfg, flipped):
        model = MGAR(c, device="cpu",
                     generator=torch.Generator().manual_seed(0))
        outs.append(make_eval_step(model)(batch))
    torch.testing.assert_close(outs[0].a_theta, outs[1].a_theta, rtol=0,
                               atol=0)
    torch.testing.assert_close(outs[0].fused_features,
                               outs[1].fused_features, rtol=0, atol=0)
