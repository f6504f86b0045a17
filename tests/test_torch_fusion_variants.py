"""Every fusion, similarity, social-layer and modality setting of the port's
GARFusionNet against the JAX one (twins of tests/test_fusion_variants.py):
the same numpy-seeded per-person features and boxes, the JAX module's
weights drawn with numpy and carried through the converter, eval forward.

Float outputs agree to 1e-4 of the largest reference value (float32 sums in
other orders); group ids are exact, every valid pair's a_theta being clear
of the 0.5 decode threshold. Widths are small (D = 32, so 8 heads of 4); the
heads' hidden width stays 512 as it is fixed in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.config import ModelConfig
from multimodal_gar_tpu.models.mgar import GARFusionNet as JaxFusionNet
from multimodal_gar_tpu_torch.models.fusion import FUSIONS
from multimodal_gar_tpu_torch.models.mgar import GARFusionNet
from tests.test_torch_common import (assert_close, port_module,
                                     random_variables, to_jax)

TOL = 1e-4
B, N, D = 2, 8, 32
FLOAT_FIELDS = ("a_theta", "card", "rgb_features", "lidar_features",
                "fused_features")
TUPLE_FIELDS = ("pose", "interaction", "sg_pose", "sg_interaction")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    valid = np.zeros((B, N), bool)
    valid[0, :5] = True
    valid[1, :3] = True
    rgb = rng.normal(size=(B, N, D)).astype(np.float32) * valid[..., None]
    lidar = rng.normal(size=(B, N, D)).astype(np.float32) * valid[..., None]
    xy = rng.uniform(0, 50, (B, N, 2))
    boxes2d = np.concatenate([xy, xy + rng.uniform(4, 30, (B, N, 2))],
                             -1).astype(np.float32) * valid[..., None]
    boxes3d = np.concatenate([rng.uniform(-4, 4, (B, N, 3)),
                              rng.uniform(0.5, 1.5, (B, N, 3)),
                              rng.uniform(-3, 3, (B, N, 1))],
                             -1).astype(np.float32) * valid[..., None]
    return rgb, lidar, boxes2d, boxes3d, valid


def _model_config(**fusion) -> ModelConfig:
    mcfg = ModelConfig()
    return dataclasses.replace(
        mcfg, rgb=dataclasses.replace(mcfg.rgb, embedding_dim=D),
        lidar=dataclasses.replace(mcfg.lidar, embedding_dim=D),
        fusion=dataclasses.replace(mcfg.fusion, hidden_dim=D,
                                   feature_dim=2 * D, **fusion))


def _spread_adjacency_(params: dict) -> None:
    """Weights of the adjacency head that put a_theta on both sides of the
    decode threshold (random draws leave every pair on one side)."""
    if "D_embed" in params:
        params["D_embed"]["kernel"] = np.array([[3.0], [4.0]], np.float32)
        params["D_embed"]["bias"] = np.array([0.5], np.float32)


def _check(**fusion):
    mcfg = _model_config(**fusion)
    rgb, lidar, boxes2d, boxes3d, valid = _inputs()
    if mcfg.fusion.modality == "RGB":
        lidar = None
    elif mcfg.fusion.modality == "LiDAR":
        rgb = None
    args = [rgb, lidar, boxes2d, boxes3d, valid]
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jmod = JaxFusionNet(mcfg)
    variables = random_variables(jmod, *jargs, train=False, seed=5)
    _spread_adjacency_(variables["params"])
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
        to_jax(variables), *jargs)
    mod = port_module(GARFusionNet, mcfg, variables=variables)
    with torch.no_grad():
        got = mod(*[None if a is None else torch.from_numpy(a)
                    for a in args])

    a = np.asarray(ref.a_theta)
    pair = valid[:, :, None] & valid[:, None, :] & ~np.eye(N, dtype=bool)
    assert np.min(np.abs(a[pair] - 0.5)) > 1e-4, "a draw at the threshold"
    np.testing.assert_array_equal(got.group_ids.numpy(),
                                  np.asarray(ref.group_ids))
    for name in FLOAT_FIELDS:
        g, r = getattr(got, name), getattr(ref, name)
        if r is None:
            assert g is None, name
            continue
        assert_close(g.numpy(), r, TOL, name)
    for name in TUPLE_FIELDS:
        gots, refs = getattr(got, name), getattr(ref, name)
        assert len(gots) == len(refs)
        for i, (g, r) in enumerate(zip(gots, refs)):
            assert_close(g.numpy(), r, TOL, f"{name}[{i}]")
    return got, mod


@pytest.mark.parametrize("fusion", FUSIONS)
def test_fusion_variant_matches_jax(fusion):
    assert len(FUSIONS) == 12
    got, _ = _check(fusion=fusion)
    wide = fusion in ("concat", "Attention_multi_cat")
    assert got.fused_features.shape[-1] == (2 * D if wide else D)


@pytest.mark.parametrize("sim", ["Graph", "Graph2", "Graph3", "Graph4"])
def test_similarity_learner_matches_jax(sim):
    _, mod = _check(sim=sim)
    # Graph2-4 give a_theta directly: no D_embed on either side
    assert hasattr(mod, "D_embed") == (sim == "Graph")


@pytest.mark.parametrize("social_layer", ["mlp", "encoder"])
def test_social_layer_matches_jax(social_layer):
    _check(social_layer=social_layer)


def test_non_euclidean_adjacency_head_matches_jax():
    _, mod = _check(euclidean=False)
    assert not hasattr(mod, "D_embed") and mod.D_embed_0.out_features == 4


def test_sg_feat_org_and_no_ind_concat_match_jax():
    got, mod = _check(sg_feat_org=True, ind_action_concat=False)
    assert mod.pose_head_1.Dense_0.in_features == 2 * D


@pytest.mark.parametrize("modality", ["RGB", "LiDAR"])
def test_single_modality_matches_jax(modality):
    got, mod = _check(modality=modality)
    other = "lidar" if modality == "RGB" else "rgb"
    assert getattr(got, f"{other}_features") is None
    assert not hasattr(mod, f"bn_{other}") and not hasattr(mod, "dafm")
    assert mod.pose_head_1.Dense_0.in_features == D
