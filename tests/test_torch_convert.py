"""convert.py: every flax leaf of the JAX MGAR is consumed and every port
tensor is filled, in the right layout; plus the shared fixtures (configs and
the synthetic batch) equal the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu.utils import testing as jax_testing
from multimodal_gar_tpu_torch.convert import convert_variables
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.utils import testing
from tests.test_torch_common import random_variables


@pytest.fixture(scope="module")
def tree():
    cfg = testing.tiny_config()
    jb = jax_testing.synthetic_batch(cfg, batch_size=1)
    variables = random_variables(JaxMGAR(cfg), jb, train=False, seed=0)
    model = MGAR(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return variables, model


def _leaves(variables):
    return {(col,) + k: v for col, t in variables.items()
            for k, v in flatten_dict(t).items()}


def test_every_leaf_consumed_and_every_tensor_filled(tree):
    variables, model = tree
    sd = convert_variables(variables, model)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(_leaves(variables))
    model.load_state_dict(sd, strict=True)


def test_layouts(tree):
    variables, model = tree
    sd = convert_variables(variables, model)
    p = variables["params"]
    stem = p["rgb_backbone"]["i3d"]["Conv3d_1a_7x7"]["conv3d"]["kernel"]
    np.testing.assert_array_equal(
        sd["rgb_backbone.i3d.Conv3d_1a_7x7.conv3d.weight"].numpy(),
        stem.transpose(4, 3, 0, 1, 2))                     # DHWIO -> OIDHW
    emb = p["rgb_backbone"]["embedding"]["kernel"]
    np.testing.assert_array_equal(
        sd["rgb_backbone.embedding.weight"].numpy(), emb.T)
    sparse = p["lidar_backbone"]["backbone3d"]["conv2_down"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        sd["lidar_backbone.backbone3d.conv2_down.conv.weight"].numpy(), sparse)
    wq = p["gar_fusion"]["dafm"]["layer_1"]["stream_l"]["WQ"]
    np.testing.assert_array_equal(
        sd["gar_fusion.dafm.layer_1.stream_l.WQ"].numpy(), wq)
    bn = p["gar_fusion"]["bn_rgb"]["BatchNorm_0"]
    np.testing.assert_array_equal(sd["gar_fusion.bn_rgb.weight"].numpy(),
                                  bn["scale"])
    var = variables["batch_stats"]["lidar_backbone"]["self_att"]["W_z_bn"]
    np.testing.assert_array_equal(
        sd["lidar_backbone.self_att.W_z_bn.running_var"].numpy(), var["var"])
    ln = p["gar_fusion"]["dafm"]["layer_0"]["stream_r"]["LN2"]
    np.testing.assert_array_equal(
        sd["gar_fusion.dafm.layer_0.stream_r.LN2.bias"].numpy(), ln["bias"])


def _edited(variables, edit):
    flat = {c: dict(flatten_dict(t)) for c, t in variables.items()}
    edit(flat)
    return {c: unflatten_dict(t) for c, t in flat.items()}


def test_raises_on_an_unconsumed_leaf(tree):
    variables, model = tree
    extra = _edited(variables, lambda f: f["params"].__setitem__(
        ("gar_fusion", "extra", "kernel"), np.zeros((2, 2), np.float32)))
    with pytest.raises(KeyError, match="no such tensor"):
        convert_variables(extra, model)


def test_raises_on_an_unfilled_tensor(tree):
    variables, model = tree
    short = _edited(variables, lambda f: f["batch_stats"].pop(
        ("gar_fusion", "bn_lidar", "BatchNorm_0", "var")))
    with pytest.raises(ValueError, match="not filled"):
        convert_variables(short, model)


def test_raises_on_a_shape_mismatch(tree):
    variables, model = tree
    bad = _edited(variables, lambda f: f["params"].__setitem__(
        ("gar_fusion", "card_net_1", "bias"), np.zeros((2,), np.float32)))
    with pytest.raises(ValueError, match="card_net_1.bias"):
        convert_variables(bad, model)


@pytest.mark.parametrize("name", ["tiny_config", "flagship_config"])
def test_configs_equal_the_jax_package(name):
    """The port builds them from its own copy of config.py: another class,
    the same tree."""
    got, ref = getattr(testing, name)(), getattr(jax_testing, name)()
    assert type(got) is not type(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_synthetic_batch_equals_the_jax_package():
    cfg = testing.tiny_config()
    ref = jax_testing.synthetic_batch(cfg, batch_size=2, seed=3)
    got = testing.synthetic_batch(cfg, batch_size=2, seed=3)
    for field in ("images", "boxes2d", "boxes3d", "person_valid",
                  "social_group_id", "actions", "social_group_activity",
                  "voxels", "voxel_coords", "voxel_num_points", "voxel_valid",
                  "seq_id", "frame_id"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    assert set(got.rulebook) == set(ref.rulebook)
    for k, v in got.rulebook.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref.rulebook[k]),
                                      k)


def test_batch_to_moves_every_tensor():
    batch = testing.synthetic_batch(testing.tiny_config(), batch_size=1)
    moved = batch.to("meta")
    assert moved.images.device.type == "meta"
    assert all(v.device.type == "meta" for v in moved.rulebook.values())
    assert moved.e_hat is None and batch.images.device.type == "cpu"
