"""The port's dense voxel query (ops/voxel.py: voxel_query) and its
window-scan reference (voxel_query_scan) against the JAX package's, with
the JAX side's selection exact (``exact=True``; the port always selects by
exact top-k). Rows and empty flags are integers and held exactly, also for
queries at voxel centres whose neighbours lie exactly on the radius: the
expanded-form distance puts them on the same side on both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.ops.voxel import build_lookup as jax_build_lookup
from multimodal_gar_tpu.ops.voxel import voxel_query as jax_voxel_query
from multimodal_gar_tpu.ops.voxel import (
    voxel_query_scan as jax_voxel_query_scan)
from multimodal_gar_tpu_torch.ops.voxel import (build_lookup, voxel_query,
                                                voxel_query_scan)
from tests.test_torch_roi_grid_pool import _query_scene

SHAPE = (4, 20, 20)


def _scene(seed, on_centres):
    centers, coords, valid, q_xyz, q_zyx, q_valid = _query_scene(seed)
    q_xyz, q_zyx, q_valid = (a.reshape(-1, *a.shape[2:])
                             for a in (q_xyz, q_zyx, q_valid))
    if on_centres:
        # queries at voxel centres, every grid step 0.5: neighbour distances
        # of 0.5, 0.71, 1.0 ... lie exactly on a radius of 1.0
        q_xyz = ((q_zyx[:, ::-1] + 0.5) * 0.5).astype(np.float32)
    return centers, coords, valid, q_xyz, q_zyx, q_valid


@pytest.mark.parametrize("seed,on_centres,radius,nsample,chunk", [
    (0, False, 0.9, 6, 2048), (1, True, 1.0, 8, 7), (2, True, 1.0, 32, 16)])
def test_dense_query_matches_jax(seed, on_centres, radius, nsample, chunk):
    centers, coords, valid, q_xyz, q_zyx, q_valid = _scene(seed, on_centres)
    ref_idx, ref_empty = jax_voxel_query(
        None, jnp.asarray(centers), jnp.asarray(q_xyz), jnp.asarray(q_zyx),
        jnp.asarray(q_valid), SHAPE, (1, 1, 1), radius, nsample,
        voxel_coords=jnp.asarray(coords), voxel_valid=jnp.asarray(valid),
        query_chunk=chunk, exact=True)
    idx, empty = voxel_query(
        *(torch.from_numpy(a)[None] for a in (centers, coords, valid, q_xyz,
                                              q_zyx, q_valid)),
        (1, 1, 1), radius, nsample, query_chunk=chunk)
    np.testing.assert_array_equal(empty[0].numpy(), np.asarray(ref_empty))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref_idx))
    assert empty.any() and not empty.all()


@pytest.mark.parametrize("seed,on_centres,radius", [(0, False, 0.9),
                                                     (1, True, 1.0)])
def test_scan_query_matches_jax_and_the_dense_query(seed, on_centres, radius):
    centers, coords, valid, q_xyz, q_zyx, q_valid = _scene(seed, on_centres)
    table = jax_build_lookup(jnp.asarray(coords), jnp.asarray(valid), SHAPE)
    ref_idx, ref_empty = jax_voxel_query_scan(
        table, jnp.asarray(centers), jnp.asarray(q_xyz), jnp.asarray(q_zyx),
        jnp.asarray(q_valid), SHAPE, (1, 1, 1), radius, 6)
    t = [torch.from_numpy(a)[None] for a in (centers, coords, valid, q_xyz,
                                             q_zyx, q_valid)]
    idx, empty = voxel_query_scan(build_lookup(t[1], t[2], SHAPE), t[0],
                                  *t[3:], SHAPE, (1, 1, 1), radius, 6)
    np.testing.assert_array_equal(empty[0].numpy(), np.asarray(ref_empty))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref_idx))
    dense, dense_empty = voxel_query(*t, (1, 1, 1), radius, 6)
    np.testing.assert_array_equal(dense_empty.numpy(), empty.numpy())
    np.testing.assert_array_equal(dense.numpy(), idx.numpy())


def test_dense_query_with_fewer_voxels_than_samples():
    """M < nsample: the priorities are padded as in the JAX package."""
    centers, coords, valid, q_xyz, q_zyx, q_valid = (
        a[:5] if i < 3 else a for i, a in enumerate(_scene(3, True)))
    ref_idx, ref_empty = jax_voxel_query(
        None, jnp.asarray(centers), jnp.asarray(q_xyz), jnp.asarray(q_zyx),
        jnp.asarray(q_valid), SHAPE, (2, 2, 2), 3.0, 8,
        voxel_coords=jnp.asarray(coords), voxel_valid=jnp.asarray(valid),
        exact=True)
    idx, empty = voxel_query(
        *(torch.from_numpy(a)[None] for a in (centers, coords, valid, q_xyz,
                                              q_zyx, q_valid)),
        (2, 2, 2), 3.0, 8)
    np.testing.assert_array_equal(empty[0].numpy(), np.asarray(ref_empty))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref_idx))
