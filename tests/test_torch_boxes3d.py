"""The port's rotated-box geometry (ops/boxes3d.py) against the JAX
package's: corners, containment, rotated BEV / 3D IoU to 1e-4 of the
largest reference value (float32, the same clipping in other orders), and
the NMS keep masks exactly, on scores without ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_gar_tpu.ops.boxes3d as jb3
import multimodal_gar_tpu_torch.ops.boxes3d as pb3
from tests.test_torch_common import assert_close

TOL = 1e-4


def _boxes(n, seed, spread=6.0):
    """(n, 7) float32 boxes in a few overlapping clusters, any yaw."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (max(n // 6, 1), 2))
    xy = centers[rng.integers(0, len(centers), n)] \
        + rng.normal(0, 0.6, (n, 2))
    z = rng.uniform(-1, 1, (n, 1))
    dims = rng.uniform(0.5, 4.0, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xy, z, dims, yaw], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_corners_and_points_in_boxes():
    b = _boxes(40, 0)
    assert_close(pb3.boxes_to_corners_3d(_t(b)).numpy(),
                 jb3.boxes_to_corners_3d(jnp.asarray(b)), TOL, "corners")
    pts = np.random.default_rng(1).uniform(-8, 8, (300, 3)).astype(np.float32)
    pts[:, 2] = np.random.default_rng(2).uniform(-2, 2, 300)
    got = pb3.points_in_boxes(_t(pts), _t(b)).numpy()
    ref = np.asarray(jb3.points_in_boxes(jnp.asarray(pts), jnp.asarray(b)))
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


@pytest.mark.parametrize("fn", ["boxes_overlap_bev", "boxes_iou_bev",
                                "boxes_iou3d", "boxes3d_nearest_bev_iou"])
def test_iou_matrices(fn):
    a, b = _boxes(36, 3), _boxes(20, 4)
    # identical, nested and touching pairs besides the random ones
    b[0] = a[0]
    b[1] = a[1] * np.array([1, 1, 1, 0.5, 0.5, 0.5, 1], np.float32)
    ref = np.asarray(jax.jit(getattr(jb3, fn))(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = getattr(pb3, fn)(_t(a), _t(b)).numpy()
    assert_close(got, ref, TOL, fn)
    assert (ref > 0).sum() > 10


def test_enlarge_box3d():
    b = _boxes(8, 5)
    assert_close(pb3.enlarge_box3d(_t(b), (0.2, 0.3, 0.4)).numpy(),
                 jb3.enlarge_box3d(jnp.asarray(b), (0.2, 0.3, 0.4)), 0,
                 "enlarge")


@pytest.mark.parametrize("fn,thr", [("nms_bev", 0.1), ("nms_bev", 0.5),
                                    ("nms_normal_bev", 0.3),
                                    ("circle_nms", 2.0)])
def test_nms_keep_masks_equal(fn, thr):
    n = 96
    b = _boxes(n, 6)
    rng = np.random.default_rng(7)
    scores = rng.permutation(n).astype(np.float32) / n     # no ties
    valid = rng.uniform(size=n) > 0.1
    ref = np.asarray(jax.jit(getattr(jb3, fn))(
        jnp.asarray(b), jnp.asarray(scores), thr, jnp.asarray(valid)))
    got = getattr(pb3, fn)(_t(b), _t(scores), thr, _t(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < valid.sum()


def test_greedy_sweep_is_the_sequential_sweep():
    """The fixed-point sweep equals a plain per-box loop, also on a long
    suppression chain (each box overlaps the next one only)."""
    n = 40
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = np.arange(n) * 0.9          # unit squares overlapping by 0.1
    b[:, 3:6] = 1.0
    scores = np.linspace(1, 0.5, n).astype(np.float32)
    iou = pb3.boxes_iou_bev(_t(b), _t(b)).numpy()
    keep = np.zeros(n, bool)
    for i in np.argsort(-scores, kind="stable"):
        keep[i] = not np.any(keep & (iou[i] > 0.05))
    got = pb3.nms_bev(_t(b), _t(scores), 0.05).numpy()
    np.testing.assert_array_equal(got, keep)
    np.testing.assert_array_equal(keep, np.arange(n) % 2 == 0)
