"""The port's VoxelBackbone8x against the JAX backbone on the tiny
synthetic batch: the x-window path (every conv through the window_conv
wrapper) and the nbr-map path (every conv through the subm_conv wrapper,
``x_window`` off).

Coords and masks must be equal. Features agree to 1e-4 of the largest
value on the x-window path, and to 1e-5 on the nbr-map path against the JAX
``x_window=False`` backbone and against the port's own x-window path:
float32 sums in other orders through up to 11 sparse convs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models.lidar_backbone import mean_vfe as jax_mean_vfe
from multimodal_gar_tpu.models.sparse_backbone import (
    SparseTensor as JaxSparseTensor, VoxelBackbone8x as JaxBackbone)
from multimodal_gar_tpu_torch.models.lidar_backbone import mean_vfe
from multimodal_gar_tpu_torch.models.sparse_backbone import (SparseTensor,
                                                             VoxelBackbone8x)
from multimodal_gar_tpu_torch.ops.kernels.subm_conv import subm_conv
from multimodal_gar_tpu_torch.ops.kernels.window_conv import window_conv
from multimodal_gar_tpu_torch.utils.testing import (synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import assert_close, port_module, random_variables

TOL = 1e-4
NBR_TOL = 1e-5
KEYS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4")


@pytest.fixture(scope="module")
def scene():
    cfg = tiny_config()
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    nx, ny, nz = cfg.data.point_cloud.grid_size
    return cfg, fields, (nz + 1, ny, nx)


def test_mean_vfe_matches_jax(scene):
    _, f, _ = scene
    ref = jax_mean_vfe(jnp.asarray(f["voxels"]),
                       jnp.asarray(f["voxel_num_points"]))
    got = mean_vfe(torch.from_numpy(f["voxels"]),
                   torch.from_numpy(f["voxel_num_points"]))
    assert_close(got.numpy(), ref, 1e-6, "mean_vfe")


def test_backbone_matches_jax(scene):
    cfg, f, shape = scene
    feats = np.asarray(jax_mean_vfe(jnp.asarray(f["voxels"]),
                                    jnp.asarray(f["voxel_num_points"])))
    feats = feats * f["voxel_valid"][..., None]
    rb = {k: jnp.asarray(v) for k, v in f["rulebook"].items()}
    jst = JaxSparseTensor(features=jnp.asarray(feats),
                          coords=jnp.asarray(f["voxel_coords"]),
                          valid=jnp.asarray(f["voxel_valid"]),
                          spatial_shape=shape)
    jmod = JaxBackbone(cfg.model.lidar.max_voxels_per_stage, x_window=True)
    variables = random_variables(jmod, jst, train=False, rulebook=rb, seed=2)
    ref = jax.jit(lambda v, s, r: jmod.apply(v, s, train=False, rulebook=r))(
        jax.tree_util.tree_map(jnp.asarray, variables), jst, rb)

    mod = port_module(VoxelBackbone8x, 4, variables=variables)
    st = SparseTensor(torch.from_numpy(feats),
                      torch.from_numpy(f["voxel_coords"]),
                      torch.from_numpy(f["voxel_valid"]), shape)
    trb = {k: torch.from_numpy(v) for k, v in f["rulebook"].items()}
    before = window_conv.launches
    with torch.no_grad():
        got = mod(st, trb)
    assert window_conv.launches == before        # the CPU runs plain only
    for key in ("x_conv1", "x_conv2", "x_conv3", "x_conv4"):
        np.testing.assert_array_equal(got[key].coords.numpy(),
                                      np.asarray(ref[key].coords))
        np.testing.assert_array_equal(got[key].valid.numpy(),
                                      np.asarray(ref[key].valid))
        assert got[key].spatial_shape == ref[key].spatial_shape
        assert_close(got[key].features.numpy(), ref[key].features, TOL, key)
        assert float(np.abs(np.asarray(ref[key].features)).max()) > 0


def test_backbone_needs_the_x_window_maps(scene):
    """Without the x-window maps the nbr maps serve; without either (a
    rulebook that lacks both families, or none) the backbone builds the nbr
    and down maps on the features' device and runs the nbr-map path over
    them, with the outputs of the host maps."""
    cfg, f, shape = scene
    mod = VoxelBackbone8x(4, device="cpu",
                          generator=torch.Generator().manual_seed(0),
                          max_voxels_per_stage=cfg.model.lidar
                          .max_voxels_per_stage).eval()
    feats = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 256, 4)).astype(np.float32) * f["voxel_valid"][..., None])
    st = SparseTensor(feats, torch.from_numpy(f["voxel_coords"]),
                      torch.from_numpy(f["voxel_valid"]), shape)
    full = {k: torch.from_numpy(v) for k, v in f["rulebook"].items()}
    stripped = {k: v for k, v in full.items()
                if "win" not in k and "nbr" not in k}
    mod.x_window = False
    with torch.no_grad():
        ref = mod(st, full)
        mod.x_window = True
        runs = [mod(st, stripped), mod(st, None)]
    for got in runs:
        for key in KEYS:
            assert torch.equal(got[key].coords, ref[key].coords), key
            assert torch.equal(got[key].valid, ref[key].valid), key
            assert torch.equal(got[key].features, ref[key].features), key
    assert set(mod.dropped_sites) == {1, 2, 3}


def _jax_run(cfg, f, shape, x_window):
    feats = np.asarray(jax_mean_vfe(jnp.asarray(f["voxels"]),
                                    jnp.asarray(f["voxel_num_points"])))
    feats = feats * f["voxel_valid"][..., None]
    rb = {k: jnp.asarray(v) for k, v in f["rulebook"].items()}
    jst = JaxSparseTensor(features=jnp.asarray(feats),
                          coords=jnp.asarray(f["voxel_coords"]),
                          valid=jnp.asarray(f["voxel_valid"]),
                          spatial_shape=shape)
    jmod = JaxBackbone(cfg.model.lidar.max_voxels_per_stage,
                       x_window=x_window)
    variables = random_variables(jmod, jst, train=False, rulebook=rb, seed=2)
    ref = jax.jit(lambda v, s, r: jmod.apply(v, s, train=False, rulebook=r))(
        jax.tree_util.tree_map(jnp.asarray, variables), jst, rb)
    return feats, variables, ref


def test_nbr_map_path_matches_jax_and_the_x_window_path(scene):
    cfg, f, shape = scene
    feats, variables, ref = _jax_run(cfg, f, shape, x_window=False)
    st = SparseTensor(torch.from_numpy(feats),
                      torch.from_numpy(f["voxel_coords"]),
                      torch.from_numpy(f["voxel_valid"]), shape)
    trb = {k: torch.from_numpy(v) for k, v in f["rulebook"].items()}
    nbr_mod = port_module(VoxelBackbone8x, 4, variables=variables,
                          x_window=False)
    xw_mod = port_module(VoxelBackbone8x, 4, variables=variables)
    k3, k2 = subm_conv.launches, window_conv.launches
    with torch.no_grad():
        got = nbr_mod(st, trb)
        xw = xw_mod(st, trb)
    assert (subm_conv.launches, window_conv.launches) == (k3, k2)
    for key in KEYS:
        np.testing.assert_array_equal(got[key].valid.numpy(),
                                      np.asarray(ref[key].valid))
        np.testing.assert_array_equal(got[key].coords.numpy(),
                                      np.asarray(ref[key].coords))
        assert_close(got[key].features.numpy(), ref[key].features, NBR_TOL,
                     key)
        assert float(np.abs(np.asarray(ref[key].features)).max()) > 0
    # the x-window path runs stage 0 in key order: compare in that order
    order = trb["order_0"].long()
    x1 = torch.gather(got["x_conv1"].features, 1,
                      order[..., None].expand(-1, -1, 16))
    assert_close(x1.numpy(), xw["x_conv1"].features.numpy(), NBR_TOL,
                 "x_conv1 vs x-window")
    for key in KEYS[1:]:
        assert_close(got[key].features.numpy(), xw[key].features.numpy(),
                     NBR_TOL, f"{key} vs x-window")
