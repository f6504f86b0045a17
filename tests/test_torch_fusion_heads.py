"""The port's fusion and heads against the JAX ones: geometry, grouping,
masked softmax, DAFM and the whole GARFusionNet at tiny widths.

Float outputs agree to 1e-4 of the largest value (float32 sums in other
orders through two DAFM layers and the heads); group ids and the grouping
primitives are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.config import ModelConfig
from multimodal_gar_tpu.models.fusion import DAFM as JaxDAFM
from multimodal_gar_tpu.models.mgar import GARFusionNet as JaxFusionNet
from multimodal_gar_tpu.ops import geometry as jgeo
from multimodal_gar_tpu.ops.grouping import (
    decode_group_ids as jax_decode, group_max_pool as jax_group_max_pool)
from multimodal_gar_tpu.ops.masked import masked_softmax as jax_softmax
from multimodal_gar_tpu_torch.models.fusion import DAFM
from multimodal_gar_tpu_torch.models.mgar import GARFusionNet
from multimodal_gar_tpu_torch.ops import geometry as geo
from multimodal_gar_tpu_torch.ops.grouping import (decode_group_ids,
                                                   group_max_pool)
from multimodal_gar_tpu_torch.ops.masked import masked_softmax
from tests.test_torch_common import (assert_close, port_module,
                                     random_variables, to_jax)

TOL = 1e-4
B, N, D = 2, 8, 32


def _actors(seed):
    rng = np.random.default_rng(seed)
    valid = np.zeros((B, N), bool)
    valid[0, :5] = True
    valid[1, :3] = True
    xy = rng.uniform(0, 100, size=(B, N, 2))
    boxes2d = np.concatenate([xy, xy + rng.uniform(5, 40, size=(B, N, 2))],
                             -1).astype(np.float32) * valid[..., None]
    boxes3d = np.concatenate([rng.uniform(-5, 5, (B, N, 3)),
                              rng.uniform(0.5, 1.5, (B, N, 3)),
                              rng.uniform(-3, 3, (B, N, 1))],
                             -1).astype(np.float32) * valid[..., None]
    return rng, valid, boxes2d, boxes3d


def test_geometry_matches_jax():
    rng, _, boxes2d, boxes3d = _actors(0)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    for b in range(B):
        assert_close(geo.pairwise_giou_2d(torch.from_numpy(boxes2d))[b],
                     jgeo.pairwise_giou_2d(jnp.asarray(boxes2d[b])), 1e-6,
                     "giou")
        assert_close(geo.pairwise_euclidean(torch.from_numpy(
            boxes3d[..., :3]))[b], jgeo.pairwise_euclidean(
            jnp.asarray(boxes3d[b, :, :3])), 1e-6, "euclidean")
        assert_close(geo.pairwise_cosine_similarity(torch.from_numpy(x))[b],
                     jgeo.pairwise_cosine_similarity(jnp.asarray(x[b])),
                     1e-6, "cosine")


def test_masked_softmax_and_grouping_match_jax():
    rng, valid, _, _ = _actors(1)
    pv = valid[:, None, :] & valid[:, :, None]
    logits = rng.normal(size=(B, N, N)).astype(np.float32)
    assert_close(masked_softmax(torch.from_numpy(logits),
                                torch.from_numpy(pv)),
                 jax_softmax(jnp.asarray(logits), jnp.asarray(pv)), 1e-6,
                 "masked_softmax")
    a = rng.uniform(size=(B, N, N)).astype(np.float32)
    feats = rng.normal(size=(B, N, D)).astype(np.float32)
    ids = decode_group_ids(torch.from_numpy(a), torch.from_numpy(valid))
    pooled = group_max_pool(torch.from_numpy(feats), ids,
                            torch.from_numpy(valid))
    for b in range(B):
        jids = jax_decode(jnp.asarray(a[b]), jnp.asarray(valid[b]))
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(jids))
        np.testing.assert_array_equal(
            pooled[b].numpy(), np.asarray(jax_group_max_pool(
                jnp.asarray(feats[b]), jids, jnp.asarray(valid[b]))))


def test_dafm_matches_jax():
    rng, valid, _, boxes3d = _actors(2)
    rgb = rng.normal(size=(B, N, D)).astype(np.float32)
    lidar = rng.normal(size=(B, N, D)).astype(np.float32)
    pv = valid[:, None, :] & valid[:, :, None]
    de = np.stack([np.asarray(jgeo.pairwise_euclidean(
        jnp.asarray(boxes3d[b, :, :3]))) for b in range(B)]) * pv
    args = [rgb, lidar, de.astype(np.float32), pv]
    jmod = JaxDAFM(dim=D, sigma=5.0, num_layers=2)
    variables = random_variables(jmod, *map(jnp.asarray, args), seed=3)
    ref = jmod.apply(to_jax(variables), *map(jnp.asarray, args))
    mod = port_module(DAFM, D, 5.0, 2, variables=variables)
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, args))
    assert_close(got.numpy(), ref, TOL, "DAFM")


def _tiny_model_config() -> ModelConfig:
    mcfg = ModelConfig()
    return dataclasses.replace(
        mcfg, rgb=dataclasses.replace(mcfg.rgb, embedding_dim=D),
        lidar=dataclasses.replace(mcfg.lidar, embedding_dim=D),
        fusion=dataclasses.replace(mcfg.fusion, hidden_dim=D,
                                   feature_dim=2 * D))


def test_fusion_net_matches_jax():
    rng, valid, boxes2d, boxes3d = _actors(4)
    rgb = rng.normal(size=(B, N, D)).astype(np.float32) * valid[..., None]
    lidar = rng.normal(size=(B, N, D)).astype(np.float32) * valid[..., None]
    args = [rgb, lidar, boxes2d, boxes3d, valid]
    mcfg = _tiny_model_config()
    jmod = JaxFusionNet(mcfg)
    variables = random_variables(jmod, *map(jnp.asarray, args), train=False,
                                 seed=5)
    # weights that put a_theta on both sides of the decode threshold
    d_embed = variables["params"]["D_embed"]
    d_embed["kernel"] = np.array([[3.0], [4.0]], np.float32)
    d_embed["bias"] = np.array([0.5], np.float32)
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
        to_jax(variables), *map(jnp.asarray, args))
    mod = port_module(GARFusionNet, mcfg, variables=variables)
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, args))

    a = np.asarray(ref.a_theta)
    pair = valid[:, :, None] & valid[:, None, :] & ~np.eye(N, dtype=bool)
    assert np.min(np.abs(a[pair] - 0.5)) > 1e-4
    assert np.any(a[pair] >= 0.5) and np.any(a[pair] < 0.5)
    np.testing.assert_array_equal(got.group_ids.numpy(),
                                  np.asarray(ref.group_ids))
    for name in ("a_theta", "card", "rgb_features", "lidar_features",
                 "fused_features"):
        assert_close(getattr(got, name).numpy(), getattr(ref, name), TOL,
                     name)
    for name in ("pose", "interaction", "sg_pose", "sg_interaction"):
        for i, (g, r) in enumerate(zip(getattr(got, name),
                                       getattr(ref, name))):
            assert_close(g.numpy(), r, TOL, f"{name}[{i}]")


@pytest.mark.parametrize("change", [dict(fusion="summation"),
                                    dict(sim="Graph5"),
                                    dict(social_layer="decoder"),
                                    dict(modality="Radar")])
def test_unported_fusion_settings_raise(change):
    """Every setting the JAX GARFusionNet honours is ported
    (tests/test_torch_fusion_variants.py); a name neither package knows
    raises at construction."""
    mcfg = _tiny_model_config()
    mcfg = dataclasses.replace(mcfg, fusion=dataclasses.replace(
        mcfg.fusion, **change))
    with pytest.raises(ValueError, match="unknown"):
        GARFusionNet(mcfg, device="cpu", generator=torch.Generator())
