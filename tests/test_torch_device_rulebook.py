"""The sparse backbone's maps built on the device (ops/device_rulebook.py)
and the no-rulebook path they feed, against the host rulebook and the JAX
package's on-device neighbour search.

The maps are integers and held exactly: against the port's build_rulebook
entry for entry (whole maps, -1 where absent, padded coords -1), and
against the JAX ``_neighbor_idx_subm`` / ``_downsample_active_set`` (whose
padded coords are 0: compared on the valid rows), the cut-off count
``dropped`` included. The backbone without a rulebook agrees with the JAX
backbone without one to 1e-5 of the largest value (float32 sums in other
orders through 11 sparse convs); the whole tiny MGAR with ``rulebook=None``
to 1e-4, group ids exact. Gradients through the device-built maps equal
those through the host maps to 1e-6 of the largest value: the same maps
feed the same operations.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu.models.lidar_backbone import mean_vfe as jax_mean_vfe
from multimodal_gar_tpu.models.sparse_backbone import (
    SparseTensor as JaxSparseTensor, VoxelBackbone8x as JaxBackbone,
    _downsample_active_set, _neighbor_idx_subm)
from multimodal_gar_tpu_torch.data.rulebook import build_rulebook
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.models.sparse_backbone import (SparseTensor,
                                                             VoxelBackbone8x)
from multimodal_gar_tpu_torch.ops.device_rulebook import (
    STAGE_PADDINGS, device_rulebook, stage_shape)
from multimodal_gar_tpu_torch.ops.kernels.subm_conv import subm_conv
from multimodal_gar_tpu_torch.train.train_state import make_eval_step
from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import (assert_close, exact_pool_config,
                                     jax_batch, port_module, random_variables,
                                     to_jax)

KEYS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4")
SHAPE = (9, 32, 32)


def _cloud(n_valid, m=200, seed=0):
    """m rows of unique zyx coords in SHAPE, the first n_valid valid, the
    rest -1 (the host rulebook's convention: valid rows first)."""
    rng = np.random.default_rng(seed)
    cells = np.stack(np.meshgrid(*map(np.arange, SHAPE), indexing="ij"),
                     -1).reshape(-1, 3)
    coords = np.full((m, 3), -1, np.int32)
    coords[:n_valid] = cells[rng.permutation(len(cells))[:n_valid]]
    return coords, np.arange(m) < n_valid


# (name, valid voxels, stage caps): an empty set, one voxel, a scene within
# its caps, and one whose strided stages overflow theirs
CASES = {"empty": (0, (200, 200, 100, 50)),
         "one voxel": (1, (200, 200, 100, 50)),
         "within caps": (150, (200, 1200, 600, 300)),
         "caps overflow": (150, (200, 60, 30, 8))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_maps_equal_the_host_rulebook(name):
    n_valid, caps = CASES[name]
    coords, valid = _cloud(n_valid, seed=len(name))
    host = build_rulebook(coords, n_valid, SHAPE, caps, x_window=False)
    dev = device_rulebook(torch.from_numpy(coords)[None],
                          torch.from_numpy(valid)[None], SHAPE, caps)
    assert set(host) < set(dev)
    for key, want in host.items():
        np.testing.assert_array_equal(dev[key][0].numpy(), want, key)
    dropped = [int(dev[f"dropped_{k}"][0]) for k in (1, 2, 3)]
    assert (sum(dropped) > 0) == (name == "caps overflow"), dropped


@pytest.mark.parametrize("name", ["caps overflow", "empty", "one voxel"])
def test_device_maps_equal_the_jax_on_device_search(name):
    n_valid, caps = CASES[name]
    coords, valid = _cloud(n_valid, seed=len(name))
    dev = device_rulebook(torch.from_numpy(coords)[None],
                          torch.from_numpy(valid)[None], SHAPE, caps)
    c, v, shape = jnp.asarray(coords)[None], jnp.asarray(valid)[None], SHAPE
    for k in range(4):
        if k:
            out_shape = stage_shape(shape, k)
            oc, ov, dropped = jax.jit(partial(
                _downsample_active_set, in_shape=shape, out_shape=out_shape,
                kernel_size=3, stride=2, padding=STAGE_PADDINGS[k],
                max_out=caps[k]))(c, v)
            got_valid = (np.arange(caps[k])
                         < dev[f"count_{k}"][0].item())
            np.testing.assert_array_equal(got_valid, np.asarray(ov)[0])
            np.testing.assert_array_equal(
                dev[f"coords_{k}"][0].numpy()[got_valid],
                np.asarray(oc)[0][got_valid])
            assert int(dev[f"dropped_{k}"][0]) == int(dropped[0]), k
            c, v, shape = oc, ov, out_shape
        nbr = jax.jit(partial(_neighbor_idx_subm, spatial_shape=shape,
                              kernel_size=3))(c, v)
        np.testing.assert_array_equal(dev[f"nbr_{k}"].numpy(),
                                      np.asarray(nbr), f"nbr_{k}")


@pytest.fixture(scope="module")
def scene():
    cfg = tiny_config()
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    nx, ny, nz = cfg.data.point_cloud.grid_size
    feats = np.asarray(jax_mean_vfe(jnp.asarray(fields["voxels"]),
                                    jnp.asarray(fields["voxel_num_points"])))
    feats = feats * fields["voxel_valid"][..., None]
    return cfg, fields, (nz + 1, ny, nx), feats


def _port_tensor(fields, shape, feats):
    return SparseTensor(torch.from_numpy(feats),
                        torch.from_numpy(fields["voxel_coords"]),
                        torch.from_numpy(fields["voxel_valid"]), shape)


def test_backbone_without_rulebook_matches_jax(scene):
    cfg, f, shape, feats = scene
    caps = cfg.model.lidar.max_voxels_per_stage
    jst = JaxSparseTensor(features=jnp.asarray(feats),
                          coords=jnp.asarray(f["voxel_coords"]),
                          valid=jnp.asarray(f["voxel_valid"]),
                          spatial_shape=shape)
    jmod = JaxBackbone(caps)
    variables = random_variables(jmod, jst, train=False, seed=2)
    ref = jax.jit(lambda v, s: jmod.apply(v, s, train=False))(
        to_jax(variables), jst)
    mod = port_module(VoxelBackbone8x, 4, variables=variables,
                      max_voxels_per_stage=caps)
    launches = subm_conv.launches
    with torch.no_grad():
        got = mod(_port_tensor(f, shape, feats))
    assert subm_conv.launches == launches          # the CPU runs plain only
    for key in KEYS:
        valid = np.asarray(ref[key].valid)
        np.testing.assert_array_equal(got[key].valid.numpy(), valid)
        np.testing.assert_array_equal(got[key].coords.numpy()[valid],
                                      np.asarray(ref[key].coords)[valid])
        assert_close(got[key].features.numpy(), ref[key].features, 1e-5,
                     key)
        assert float(np.abs(np.asarray(ref[key].features)).max()) > 0
    # the tiny caps cut stage 1 and 2 off: the counts are exposed
    assert all(mod.dropped_sites[k].shape == (2,) for k in (1, 2, 3))
    assert int(mod.dropped_sites[1].sum()) > 0


def test_backbone_gradients_through_device_maps_equal_host_maps(scene):
    cfg, f, shape, feats = scene
    caps = cfg.model.lidar.max_voxels_per_stage
    gen = torch.Generator().manual_seed(3)
    mod = VoxelBackbone8x(4, device="cpu", generator=gen, x_window=False,
                          max_voxels_per_stage=caps).train()
    host = {k: torch.from_numpy(v) for k, v in f["rulebook"].items()}
    probe = {k: torch.randn((2, n, c), generator=gen)
             for k, n, c in (("x_conv1", 256, 16), ("x_conv2", 128, 32),
                             ("x_conv3", 64, 64), ("x_conv4", 32, 64))}
    grads = []
    for rb in (host, None):
        out = mod(_port_tensor(f, shape, feats), rb)
        loss = sum((out[k].features * probe[k]).sum() for k in KEYS)
        grads.append(torch.autograd.grad(loss, list(mod.parameters())))
    for (name, _), g_host, g_dev in zip(mod.named_parameters(), *grads):
        assert_close(g_dev.numpy(), g_host.numpy(), 1e-6, name)
    assert float(grads[0][0].abs().max()) > 0


def test_mgar_without_rulebook_matches_jax():
    cfg = exact_pool_config(tiny_config())
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    fields.pop("rulebook")
    jb = jax_batch(fields)
    assert jb.rulebook is None
    jmodel = JaxMGAR(cfg)
    variables = random_variables(jmodel, jb, train=False, seed=0)
    # a_theta on both sides of the 0.5 threshold, well clear of it (as in
    # tests/test_torch_slice.py)
    d_embed = variables["params"]["gar_fusion"]["D_embed"]
    d_embed["kernel"] = np.array([[1.0], [4.0]], np.float32)
    d_embed["bias"] = np.array([0.3], np.float32)
    ref = jax.jit(partial(jmodel.apply, train=False))(to_jax(variables), jb)
    got = make_eval_step(port_module(MGAR, cfg, variables=variables))(
        batch_from_numpy(fields))
    for name in ("a_theta", "card", "rgb_features", "lidar_features",
                 "fused_features"):
        assert_close(getattr(got, name), getattr(ref, name), 1e-4, name)
    for name in ("pose", "interaction", "sg_pose", "sg_interaction"):
        for i, (g, r) in enumerate(zip(getattr(got, name),
                                       getattr(ref, name))):
            assert_close(g, r, 1e-4, f"{name}[{i}]")
    np.testing.assert_array_equal(got.group_ids.numpy(),
                                  np.asarray(ref.group_ids))
