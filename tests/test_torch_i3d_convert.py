"""The port's Kinetics I3D checkpoint loader against the JAX package's: a
state dict drawn with numpy under the published ``rgb_imagenet.pt`` key list
(tests/data/manifest_i3d_rgb_imagenet.txt, shapes from tests/test_i3d.py's
fabricated checkpoint) goes through both loaders, and both I3Ds then give
the same features (1e-4 of the largest reference value) on a numpy-seeded
clip. Also: the loaded tensors are the checkpoint's, exactly; deeper
endpoints and the logits head are dropped; a shape mismatch and a checkpoint
that matches nothing raise; a file on disk loads as the in-memory dict."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models.i3d import InceptionI3d as JaxI3d
from multimodal_gar_tpu.models.i3d_convert import (
    load_i3d_checkpoint as jax_load_i3d_checkpoint)
from multimodal_gar_tpu_torch.models.i3d import InceptionI3d
from multimodal_gar_tpu_torch.models.i3d_convert import (
    IGNORED_LEAVES, convert_state_dict, load_i3d_checkpoint, unconsumed_keys)
from tests.test_i3d import _fabricate_full_i3d_state_dict
from tests.test_torch_common import assert_close

TOL = 1e-4
MANIFEST = os.path.join(os.path.dirname(__file__), "data",
                        "manifest_i3d_rgb_imagenet.txt")


def _manifest():
    with open(MANIFEST) as f:
        return [ln.strip() for ln in f if ln.strip()]


@pytest.fixture(scope="module")
def state_dict():
    """The published keys with numpy-drawn values: kernels N(0, 1 / fan_in),
    BN scales and variances U(0.5, 1.5), biases and means N(0, 0.1)."""
    shapes = _fabricate_full_i3d_state_dict()
    assert sorted(shapes) == sorted(_manifest())
    rng = np.random.default_rng(0)
    sd = {}
    for name in sorted(shapes):
        shape = shapes[name].shape
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[name] = np.asarray(7, np.int64)
        elif len(shape) == 5:
            sd[name] = rng.normal(0, np.prod(shape[1:]) ** -0.5, shape)
        elif leaf == "running_var" or (leaf == "weight" and ".bn." in name):
            sd[name] = rng.uniform(0.5, 1.5, shape)
        else:
            sd[name] = rng.normal(0, 0.1, shape)
        sd[name] = sd[name].astype(shapes[name].dtype)
    return sd


class _Holder(torch.nn.Module):
    """A model with its I3D at ``rgb_backbone.i3d``, as MGAR has it."""

    def __init__(self, **kw):
        super().__init__()
        self.rgb_backbone = torch.nn.Module()
        self.rgb_backbone.i3d = InceptionI3d(
            "Mixed_4f", device="cpu",
            generator=torch.Generator().manual_seed(0), **kw).eval()


def test_every_published_key_is_mapped_or_ignored(state_dict):
    manifest = _manifest()
    assert unconsumed_keys(dict.fromkeys(manifest)) == []
    bad = dict.fromkeys(manifest + ["Mixed_3b.b0.conv3d.weigth",
                                    "features.0.weight"])
    assert sorted(unconsumed_keys(bad)) == ["Mixed_3b.b0.conv3d.weigth",
                                            "features.0.weight"]
    converted = convert_state_dict(state_dict)
    ignored = [k for k in manifest if k.endswith(IGNORED_LEAVES)]
    assert len(converted) == len(manifest) - len(ignored)


def test_loaded_tensors_are_the_checkpoints(state_dict):
    """All 45 Unit3D units up to Mixed_4f take their five tensors from the
    checkpoint, and nothing else of the model moves; Mixed_5*, logits and
    num_batches_tracked are dropped."""
    model = _Holder()
    load_i3d_checkpoint(model, state_dict)
    own = model.rgb_backbone.i3d.state_dict()
    assert len(own) == 45 * 5
    for key, value in own.items():
        np.testing.assert_array_equal(value.numpy(), state_dict[key],
                                      err_msg=key)
    assert not any(k.startswith(("Mixed_5", "logits")) for k in own)


@pytest.mark.parametrize("center", [True, False],
                         ids=["center_slice", "full"])
def test_i3d_output_matches_jax_after_both_loaders(state_dict, center):
    shape = (1, 15, 32, 48, 3) if center else (2, 4, 30, 36, 3)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jmod = JaxI3d(final_endpoint="Mixed_4f", center_slice=center)
    v = jax.jit(lambda k, a: jmod.init(k, a, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    wrapped = {"params": {"rgb_backbone": {"i3d": v["params"]}},
               "batch_stats": {"rgb_backbone": {"i3d": v["batch_stats"]}}}
    loaded = jax_load_i3d_checkpoint(wrapped, state_dict)
    ref = jax.jit(lambda p, s, a: jmod.apply(
        {"params": p, "batch_stats": s}, a, train=False))(
        loaded["params"]["rgb_backbone"]["i3d"],
        loaded["batch_stats"]["rgb_backbone"]["i3d"], jnp.asarray(x))
    model = load_i3d_checkpoint(_Holder(center_slice=center), state_dict)
    with torch.no_grad():
        before = _Holder(center_slice=center).rgb_backbone.i3d(
            torch.from_numpy(x))
        got = model.rgb_backbone.i3d(torch.from_numpy(x))
    assert_close(got.numpy(), ref, TOL, "I3D after both loaders")
    assert not torch.allclose(got, before)       # the weights did change


def test_a_checkpoint_file_loads_as_the_dict(state_dict, tmp_path):
    path = str(tmp_path / "rgb_imagenet.pt")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in state_dict.items()}, path)
    from_file = load_i3d_checkpoint(_Holder(), path).state_dict()
    from_dict = load_i3d_checkpoint(_Holder(), state_dict).state_dict()
    assert list(from_file) == list(from_dict)
    for k, v in from_dict.items():
        assert torch.equal(from_file[k], v), k


def test_shape_mismatch_and_no_match_raise(state_dict):
    bad = dict(state_dict)
    bad["Mixed_3b.b0.conv3d.weight"] = np.zeros((64, 192, 3, 3, 3),
                                                np.float32)
    with pytest.raises(ValueError, match="Mixed_3b.b0.conv3d.weight"):
        load_i3d_checkpoint(_Holder(), bad)
    deeper = {k: v for k, v in state_dict.items()
              if k.startswith(("Mixed_5", "logits"))}
    with pytest.raises(ValueError, match="no I3D parameters matched"):
        load_i3d_checkpoint(_Holder(), deeper)
    stats_only = {k: v for k, v in state_dict.items() if "running_" in k}
    with pytest.raises(ValueError, match="no I3D parameters matched"):
        load_i3d_checkpoint(_Holder(), stats_only)
