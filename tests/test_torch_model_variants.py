"""The backbone attention options of the port against the JAX package's
(twins of tests/test_model_variants.py): GATv2Layer, SpaTempSelfAtt with
both pools, the RGB ``two_stage_att`` / ``inter_person`` / ``gat_module``
paths and the LiDAR ``two_stage_att`` / ``self_att_inter_person`` /
``self_att_use: false`` (shared FC) paths, each in the eval and in the
training forward.

Same numpy-seeded inputs, the JAX module's weights and BatchNorm statistics
drawn with numpy and carried through the converter; outputs, and after a
training forward the new BatchNorm statistics, agree to 1e-4 of the largest
reference value. Dropout is off on both sides in training (the two
generators cannot match): p = 0 in the port, a test-local identity in place
of ``flax.linen.Dropout.__call__``. The RGB paths read block-structured
frames and person-sized boxes (utils/testing.py: condition_for_grad_parity_):
on white-noise frames the rows of a training BatchNorm are near-identical
and its E[x^2] - E[x]^2 turns float32 rounding into large errors on every
implementation.
"""
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodal_gar_tpu.models.gat import GATv2Layer as JaxGAT
from multimodal_gar_tpu.models.lidar_backbone import (
    LiDARBackbone as JaxLiDAR)
from multimodal_gar_tpu.models.rgb_backbone import RGBBackbone as JaxRGB
from multimodal_gar_tpu.models.spa_temp import SpaTempSelfAtt as JaxSpaTemp
from multimodal_gar_tpu_torch.convert import _target
from multimodal_gar_tpu_torch.models.gat import GATv2Layer
from multimodal_gar_tpu_torch.models.lidar_backbone import LiDARBackbone
from multimodal_gar_tpu_torch.models.rgb_backbone import RGBBackbone
from multimodal_gar_tpu_torch.models.spa_temp import SpaTempSelfAtt
from multimodal_gar_tpu_torch.utils.testing import (
    condition_for_grad_parity_, synthetic_batch_numpy, tiny_config)
from tests.test_torch_common import (assert_close, exact_pool_config,
                                     port_module, random_variables, to_jax)

TOL = 1e-4
MODES = pytest.mark.parametrize("train", [False, True],
                                ids=["eval", "training"])


def _zero_w_z_bias_(tree: dict) -> None:
    """The non-local blocks' W_z biases at their init value, zero, as
    utils/testing.py: prepare_grad_parity_ sets them: a random bias dwarfs
    the spread of W_z's output over the rows, and the training BatchNorm
    after it then amplifies rounding by mean^2 / var."""
    for name, sub in tree.items():
        if name == "W_z":
            sub["bias"] = np.zeros_like(sub["bias"])
        elif isinstance(sub, dict):
            _zero_w_z_bias_(sub)


def _compare(jmod, mod_cls, mod_args, jargs, jkwargs, args, train,
             seed=0, mod_kwargs=None, zero_w_z_bias=False):
    """Run the JAX module and the port's on the same inputs and weights;
    hold the output and, in training, the new BatchNorm statistics (the
    frozen I3D's must stay)."""
    variables = random_variables(jmod, *jargs, seed=seed, **jkwargs)
    if zero_w_z_bias:
        _zero_w_z_bias_(variables["params"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        if train:
            ref, updates = jax.jit(lambda v, *a: jmod.apply(
                v, *a, mutable=["batch_stats"], **jkwargs))(
                to_jax(variables), *jargs)
        else:
            ref = jax.jit(lambda v, *a: jmod.apply(v, *a, **jkwargs))(
                to_jax(variables), *jargs)
    mod = port_module(mod_cls, *mod_args, variables=variables,
                      **(mod_kwargs or {}))
    for m in mod.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    mod.train(train)
    with torch.no_grad():
        got = mod(*args)
    assert_close(got.numpy(), ref, TOL, "output")
    assert float(np.abs(np.asarray(ref)).max()) > 0
    if train:
        state = mod.state_dict()
        flat = flatten_dict(jax.tree_util.tree_map(
            np.asarray, updates.get("batch_stats", {})))
        for path, v in flat.items():
            key, want = _target("batch_stats", path, v)
            assert_close(state[key].numpy(), want, TOL, key)
            before = flatten_dict(variables["batch_stats"])[path]
            assert np.array_equal(before, want) == (path[0] == "i3d"), key
    return got


@MODES
def test_gatv2_layer_matches_jax(train):
    rng = np.random.default_rng(0)
    b, n, c, d = 2, 6, 24, 16
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    valid = np.array([[True] * 4 + [False] * 2, [True] * 6])
    got = _compare(JaxGAT(d, num_heads=4), GATv2Layer, (c, d),
                   [jnp.asarray(x), jnp.asarray(valid)],
                   dict(deterministic=not train),
                   [torch.from_numpy(x), torch.from_numpy(valid)], train,
                   mod_kwargs=dict(num_heads=4))
    assert got.shape == (b, n, d) and not got[0, 4:].any()


@MODES
@pytest.mark.parametrize("pool", ["avg", "flat"])
def test_spa_temp_self_att_matches_jax(pool, train):
    rng = np.random.default_rng(1)
    n, h, w, c = 5, 3, 3, 16
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    got = _compare(JaxSpaTemp(c, 2, "dot", pool=pool), SpaTempSelfAtt,
                   (c, 2), [jnp.asarray(x)], dict(train=train),
                   [torch.from_numpy(x)], train,
                   mod_kwargs=dict(pool=pool, patch_positions=h * w))
    assert got.shape == (n, c if pool == "avg" else h * w * c)


@pytest.fixture(scope="module")
def lidar_scene():
    cfg = exact_pool_config(tiny_config())
    return cfg, synthetic_batch_numpy(cfg, batch_size=2, seed=0)


@pytest.fixture(scope="module")
def scene():
    cfg = exact_pool_config(tiny_config())
    # every slot holds a person, as in tests/test_model_variants.py: the
    # two-stage and inter-person blocks' training BatchNorms count padded
    # rows too, and identical padded rows are ill-conditioned in the sense
    # above
    return cfg, condition_for_grad_parity_(synthetic_batch_numpy(
        cfg, batch_size=2, seed=0, n_valid=cfg.data.num_boxes))


@MODES
@pytest.mark.parametrize("flag", ["two_stage_att", "inter_person",
                                  "gat_module"])
def test_rgb_backbone_variant_matches_jax(scene, flag, train):
    cfg, f = scene
    rcfg = dataclasses.replace(cfg.model.rgb, **{flag: True})
    names = ("images", "boxes2d")
    jmod = JaxRGB(rcfg)
    got = _compare(jmod, RGBBackbone, (rcfg,),
                   [jnp.asarray(f[k]) for k in names],
                   dict(train=train, valid=jnp.asarray(f["person_valid"])),
                   [torch.from_numpy(f[k]) for k in names]
                   + [torch.from_numpy(f["person_valid"])], train, seed=2,
                   zero_w_z_bias=True)
    assert got.shape == f["person_valid"].shape + (rcfg.embedding_dim,)


@MODES
@pytest.mark.parametrize("variant", ["two_stage", "inter_person",
                                     "shared_fc"])
def test_lidar_backbone_variant_matches_jax(lidar_scene, variant, train):
    cfg, f = lidar_scene
    over = {"inter_person": {"self_att_inter_person": True},
            "two_stage": {"two_stage_att": True},
            "shared_fc": {"self_att_use": False, "shared_fc": (48, 32)}}
    lcfg = dataclasses.replace(cfg.model.lidar, **over[variant])
    names = ("voxels", "voxel_coords", "voxel_num_points", "voxel_valid",
             "boxes3d", "person_valid")
    rb = f["rulebook"]
    got = _compare(JaxLiDAR(lcfg, cfg.data.point_cloud), LiDARBackbone,
                   (lcfg, cfg.data.point_cloud),
                   [jnp.asarray(f[k]) for k in names],
                   dict(train=train,
                        rulebook={k: jnp.asarray(v) for k, v in rb.items()}),
                   [torch.from_numpy(f[k]) for k in names]
                   + [{k: torch.from_numpy(v) for k, v in rb.items()}],
                   train, seed=3)
    width = 32 if variant == "shared_fc" else lcfg.embedding_dim
    assert got.shape == f["person_valid"].shape + (width,)
    assert not got[~torch.from_numpy(f["person_valid"])].any()
