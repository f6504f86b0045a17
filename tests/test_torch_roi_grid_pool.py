"""The port's ROI grid pool and LiDAR branch against the JAX ones, with
the culled query and, where it is asked for, the dense one, the exact one
and the mean over the samples.

The neighbour query is held exactly (same selected voxel rows, same empty
flags) with the JAX side set to exact top-k selection, which is the port's;
pooled features and the LiDAR embedding agree to 1e-4 of the largest value
(float32 sums in other orders through the sparse backbone and the MLPs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodal_gar_tpu.models.lidar_backbone import (
    LiDARBackbone as JaxLiDAR)
from multimodal_gar_tpu.models.roi_grid_pool import (
    ROIGridPool as JaxGridPool, roi_grid_points as jax_roi_grid_points)
from multimodal_gar_tpu.models.sparse_backbone import (
    SparseTensor as JaxSparseTensor)
from multimodal_gar_tpu.ops.voxel import (
    voxel_query_boxed as jax_voxel_query_boxed)
from multimodal_gar_tpu_torch.convert import _target
from multimodal_gar_tpu_torch.models.lidar_backbone import LiDARBackbone
from multimodal_gar_tpu_torch.models.roi_grid_pool import (ROIGridPool,
                                                           roi_grid_points)
from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
from multimodal_gar_tpu_torch.ops.voxel import voxel_query_boxed
from multimodal_gar_tpu_torch.utils.testing import (synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import (assert_close, exact_pool_config,
                                     port_module, random_variables, to_jax)

TOL = 1e-4


def _query_scene(seed, m=300, n=5, g3=8):
    """Unique voxels on a small grid and boxes of query points among them."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(20), np.arange(20),
                                indexing="ij"), -1).reshape(-1, 3)
    coords = grid[rng.permutation(len(grid))[:m]].astype(np.int32)
    valid = np.ones(m, bool)
    valid[-20:] = False
    vs, pc_min = np.array([0.5, 0.5, 0.5]), np.array([0.0, 0.0, 0.0])
    centers = ((coords[:, ::-1] + 0.5) * vs + pc_min).astype(np.float32)
    box = rng.uniform([1, 1, 0.2], [9, 9, 1.8], size=(n, 1, 3))
    q_xyz = (box + rng.normal(0, 0.6, size=(n, g3, 3))).astype(np.float32)
    q_zyx = np.floor((q_xyz - pc_min) / vs).astype(np.int32)[..., ::-1].copy()
    q_valid = np.ones((n, g3), bool)
    q_valid[-1] = False
    return centers, coords, valid, q_xyz, q_zyx, q_valid


@pytest.mark.parametrize("cull_k", [64, 512])
def test_voxel_query_boxed_selects_the_same_voxels(cull_k):
    args = _query_scene(0)
    jrows, jempty = jax_voxel_query_boxed(
        *map(jnp.asarray, args), (1, 1, 1), 0.9, 6, cull_k=cull_k,
        approx_nsample=False)
    cand, local, empty = voxel_query_boxed(
        *(torch.from_numpy(a)[None] for a in args), (1, 1, 1), 0.9, 6,
        cull_k)
    g3 = args[3].shape[1]
    rows = torch.gather(cand[0].repeat_interleave(g3, 0), 1, local[0])
    rows = torch.where(empty[0][:, None], 0, rows)
    np.testing.assert_array_equal(empty[0].numpy(), np.asarray(jempty))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert not empty.all() and empty.any()


def test_roi_grid_points_match_jax():
    rng = np.random.default_rng(1)
    rois = np.concatenate([rng.uniform(-5, 5, (2, 4, 3)),
                           rng.uniform(0.5, 2, (2, 4, 3)),
                           rng.uniform(-3, 3, (2, 4, 1))],
                          -1).astype(np.float32)
    got = roi_grid_points(torch.from_numpy(rois), 3)
    for b in range(2):
        ref = jax_roi_grid_points(jnp.asarray(rois[b]), 3)
        assert_close(got[b].numpy(), ref, 1e-6, "roi_grid_points")


@pytest.fixture(scope="module")
def scene():
    cfg = exact_pool_config(tiny_config())
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    return cfg, fields


def _multiscale(fields, seed):
    """Random stage features on the rulebook's active sets, for both
    packages."""
    rng = np.random.default_rng(seed)
    rb = fields["rulebook"]
    shape = (0, 0, 0)                  # the culled pool reads no grid shape
    stage = {"x_conv2": 1, "x_conv4": 3}
    jms, ms = {}, {}
    for key, k in stage.items():
        coords = rb[f"coords_{k}"]
        valid = np.arange(coords.shape[1])[None] < rb[f"count_{k}"][:, None]
        c = 32 if key == "x_conv2" else 64
        f = rng.normal(size=coords.shape[:2] + (c,)).astype(np.float32)
        f *= valid[..., None]
        jms[key] = JaxSparseTensor(jnp.asarray(f), jnp.asarray(coords),
                                   jnp.asarray(valid), shape)
        ms[key] = SparseTensor(torch.from_numpy(f), torch.from_numpy(coords),
                               torch.from_numpy(valid), shape)
    return jms, ms


def test_roi_grid_pool_matches_jax(scene):
    cfg, f = scene
    jms, ms = _multiscale(f, 3)
    lcfg, pc = cfg.model.lidar, cfg.data.point_cloud
    jmod = JaxGridPool(lcfg, pc)
    args = (jnp.asarray(f["boxes3d"]), jnp.asarray(f["person_valid"]))
    variables = random_variables(jmod, jms, *args, train=False, seed=4)
    ref, _ = jax.jit(lambda v, m, *a: jmod.apply(v, m, *a, train=False))(
        to_jax(variables), jms, *args)
    mod = port_module(ROIGridPool, lcfg, pc, variables=variables)
    with torch.no_grad():
        got, shared = mod(ms, torch.from_numpy(f["boxes3d"]),
                          torch.from_numpy(f["person_valid"]))
    assert shared is None                       # no shared FC unless asked
    assert_close(got.numpy(), ref, TOL, "ROIGridPool")
    assert float(np.abs(np.asarray(ref)).max()) > 0


def test_lidar_backbone_matches_jax(scene):
    cfg, f = scene
    lcfg, pc = cfg.model.lidar, cfg.data.point_cloud
    names = ("voxels", "voxel_coords", "voxel_num_points", "voxel_valid",
             "boxes3d", "person_valid")
    jargs = [jnp.asarray(f[k]) for k in names]
    rb = {k: jnp.asarray(v) for k, v in f["rulebook"].items()}
    jmod = JaxLiDAR(lcfg, pc)
    variables = random_variables(jmod, *jargs, train=False, rulebook=rb,
                                 seed=5)
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a[:-1], train=False,
                                           rulebook=a[-1]))(
        to_jax(variables), *jargs, rb)
    mod = port_module(LiDARBackbone, lcfg, pc, variables=variables)
    with torch.no_grad():
        got = mod(*[torch.from_numpy(f[k]) for k in names],
                  {k: torch.from_numpy(v) for k, v in f["rulebook"].items()})
    assert_close(got.numpy(), ref, TOL, "LiDARBackbone")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "training"])
@pytest.mark.parametrize("option", ["pool_cull_k=0", "voxel_query_exact",
                                    "avg_pool"])
def test_unported_lidar_options_raise(scene, option, train):
    """The grid-pool options that raised before the dense query was ported
    (the name is kept): the dense query (``pool_cull_k`` 0), the exact query
    (which overrides the cull) and the mean over the samples, each against
    the JAX grid pool, with the new BatchNorm statistics in training."""
    cfg, f = scene
    mean_pool = tuple(dataclasses.replace(lc, pool_method="avg_pool")
                      for lc in cfg.model.lidar.pool_layers)
    change = {"pool_cull_k=0": dict(pool_cull_k=0),
              "voxel_query_exact": dict(voxel_query_exact=True),
              "avg_pool": dict(pool_layers=mean_pool)}[option]
    lcfg = dataclasses.replace(cfg.model.lidar, **change)
    pc = cfg.data.point_cloud
    jms, ms = _multiscale(f, 3)
    jmod = JaxGridPool(lcfg, pc)
    args = (jnp.asarray(f["boxes3d"]), jnp.asarray(f["person_valid"]))
    variables = random_variables(jmod, jms, *args, train=False, seed=4)
    run = jax.jit(lambda v, m, *a: jmod.apply(
        v, m, *a, train=train, mutable=["batch_stats"] if train else False))
    ref = run(to_jax(variables), jms, *args)
    (ref, _), updates = ref if train else (ref, None)
    mod = port_module(ROIGridPool, lcfg, pc, variables=variables)
    mod.train(train)
    with torch.no_grad():
        got, _ = mod(ms, torch.from_numpy(f["boxes3d"]),
                     torch.from_numpy(f["person_valid"]))
    assert_close(got.numpy(), ref, TOL, option)
    assert float(np.abs(np.asarray(ref)).max()) > 0
    if train:
        state = mod.state_dict()
        flat = flatten_dict(jax.tree_util.tree_map(
            np.asarray, updates["batch_stats"]))
        for path, v in flat.items():
            key, want = _target("batch_stats", path, v)
            assert_close(state[key].numpy(), want, TOL, key)
