"""Port kernel 2 (ops/kernels/window_conv.py) against the JAX x-window conv.

On the rulebook scenes of tests/test_sparse_xwindow.py the plain version is
held to the JAX XLA path (window_gather + einsum), to the Pallas band kernel
and to the Pallas dynamic-gather kernel (both in interpret mode), at 1e-5
of the largest value: every side sums the same float32 products, in other
orders. Submanifold maps (R = M) and strided maps (R != M) are both covered.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.data.rulebook import build_rulebook
from multimodal_gar_tpu.models.sparse_backbone import (
    window_gather as jax_window_gather)
from multimodal_gar_tpu.ops.pallas.window_conv import (window_conv_band,
                                                       window_conv_pallas)
from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
    window_conv, window_conv_plain, window_gather)
from multimodal_gar_tpu_torch.ops.kernels.subm_conv import subm_conv_plain
from multimodal_gar_tpu_torch.utils.testing import (
    clustered_rulebook_numpy, tiny_config, window_edge_cases,
    window_index_map, window_taps)
from tests.test_torch_common import assert_close

TOL = 1e-5


def _dense_coords(shape, rng, drop):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    coords = np.stack([zz.ravel(), yy.ravel(), xx.ravel()],
                      -1).astype(np.int32)
    coords = coords[rng.uniform(size=len(coords)) >= drop]
    return coords[rng.permutation(len(coords))]


def _scene(shape, seed, drop):
    """A rulebook over a partly occupied grid, padded to a multiple of 8."""
    rng = np.random.default_rng(seed)
    coords = _dense_coords(shape, rng, drop)
    n = len(coords)
    cap = ((n + 8 + 7) // 8) * 8
    coords_p = np.concatenate([coords, np.full((cap - n, 3), -1, np.int32)])
    rb = build_rulebook(coords_p, n, shape, (cap, cap, cap, cap),
                        x_window=True)
    return rng, cap, rb


def _jax_conv(feats, win, w):
    return np.asarray(jnp.einsum(
        "rkc,kcd->rd", jax_window_gather(jnp.asarray(feats),
                                         jnp.asarray(win)), jnp.asarray(w)))


def _port_conv(feats, win, w):
    return window_conv_plain(torch.from_numpy(feats)[None],
                             torch.from_numpy(win)[None],
                             torch.from_numpy(w))[0].numpy()


@pytest.mark.parametrize("shape,seed,drop", [((6, 10, 12), 5, 0.5),
                                             ((4, 6, 8), 3, 0.4)])
def test_window_conv_matches_xla_path(shape, seed, drop):
    rng, cap, rb = _scene(shape, seed, drop)
    c, d = 8, 16
    feats = rng.normal(size=(cap, c)).astype(np.float32)[rb["order_0"]]
    w = (rng.normal(size=(27, c, d)) * 0.1).astype(np.float32)
    assert_close(_port_conv(feats, rb["win_0"], w),
                 _jax_conv(feats, rb["win_0"], w), TOL, "win_0")
    for k in (1, 2, 3):                      # strided maps into stage k-1
        win = rb[f"dwin_{k}"]
        table = rng.normal(size=(cap, c)).astype(np.float32)
        assert_close(_port_conv(table, win, w), _jax_conv(table, win, w),
                     TOL, f"dwin_{k}")


def test_window_conv_strided_rows_differ_from_table_rows():
    """R != M: a dwin map of a shorter output stage over a longer table."""
    rng, cap, rb = _scene((6, 10, 12), 7, 0.3)
    n_out = int(rb["count_1"])
    win = rb["dwin_1"][:max(n_out // 2, 1)]
    table = rng.normal(size=(cap, 16)).astype(np.float32)
    w = (rng.normal(size=(27, 16, 32)) * 0.1).astype(np.float32)
    got = _port_conv(table, win, w)
    assert got.shape == (win.shape[0], 32) and win.shape[0] != cap
    assert_close(got, _jax_conv(table, win, w), TOL, "R != M")


def test_window_conv_matches_pallas_band_and_gather_kernels():
    rng, cap, rb = _scene((6, 10, 12), 5, 0.5)
    c, d = 8, 16
    feats = rng.normal(size=(cap, c)).astype(np.float32)[rb["order_0"]]
    w = (rng.normal(size=(27, c, d)) * 0.1).astype(np.float32)
    win = rb["win_0"]
    got = _port_conv(feats, win, w)
    band, viol = window_conv_band(jnp.asarray(feats), jnp.asarray(win),
                                  jnp.asarray(w), band=128, qb=64,
                                  interpret=True, check=True)
    assert int(viol) == 0
    assert_close(got, band, TOL, "band kernel")
    gather = window_conv_pallas(jnp.asarray(feats), jnp.asarray(win),
                                jnp.asarray(w), interpret=True)
    assert_close(got, gather, TOL, "dynamic-gather kernel")


def test_window_gather_matches_jax_exactly():
    rng, cap, rb = _scene((4, 5, 6), 0, 0.3)
    feats = rng.normal(size=(cap, 7)).astype(np.float32)[rb["order_0"]]
    for key in ("win_0", "dwin_1"):
        ref = np.asarray(jax_window_gather(jnp.asarray(feats),
                                           jnp.asarray(rb[key])))
        got = window_gather(torch.from_numpy(feats)[None],
                            torch.from_numpy(rb[key])[None])[0].numpy()
        np.testing.assert_array_equal(got, ref)


def test_window_conv_wrapper_takes_the_plain_version_on_cpu():
    rng, cap, rb = _scene((4, 6, 8), 1, 0.4)
    feats = torch.from_numpy(rng.normal(size=(2, cap, 16)).astype(np.float32))
    win = torch.from_numpy(np.stack([rb["win_0"]] * 2))
    w = torch.from_numpy(rng.normal(size=(27, 16, 16)).astype(np.float32))
    before = window_conv.launches
    with torch.no_grad():
        got = window_conv(feats, win, w)
    torch.testing.assert_close(got, window_conv_plain(feats, win, w),
                               rtol=0, atol=0)
    assert window_conv.launches == before


def test_window_conv_wrapper_checks_its_inputs():
    feats = torch.zeros((1, 8, 16))
    win = torch.zeros((1, 8, 9), dtype=torch.int32)
    w = torch.zeros((27, 16, 16))
    with pytest.raises(RuntimeError, match="explicit maps"):
        window_conv(feats, win, w.requires_grad_())    # backward needs maps
    w = w.detach()
    with pytest.raises(TypeError):
        window_conv(feats, win.long(), w)
    with pytest.raises(ValueError):
        window_conv(feats, win, torch.zeros((27, 8, 16)))
    with pytest.raises(ValueError):
        window_conv(feats, win[:, :, :8], w)


_EDGE_NAMES = [case[0] for case in window_edge_cases()]


@pytest.mark.parametrize("name", _EDGE_NAMES)
def test_window_conv_plain_matches_xla_at_the_kernel_edge_cases(name):
    """The inputs tests/test_torch_cuda.py runs through the kernel (R below
    a tile, ragged tiles, absent stretches, B = 2, R != M), plain version
    against the JAX window_gather + einsum."""
    feats, win, w = next(c[1:] for c in window_edge_cases() if c[0] == name)
    with torch.no_grad():
        got = window_conv(*map(torch.from_numpy, (feats, win, w))).numpy()
    assert got.shape == win.shape[:2] + (w.shape[-1],)
    for b in range(feats.shape[0]):
        assert_close(got[b], _jax_conv(feats[b], win[b], w), TOL,
                     f"{name}, item {b}")


@pytest.mark.parametrize("name", _EDGE_NAMES)
def test_window_index_map_gives_k3_the_same_taps(name):
    """The explicit maps that chip_smoke.py 15b and tests/test_torch_cuda.py
    decode from the edge cases' packed maps (utils/testing.py:
    window_index_map) give K3's plain version the x-window layer's taps:
    the same sums, and the same present-tap count."""
    feats, win, w = (torch.from_numpy(a) for a in next(
        c[1:] for c in window_edge_cases(seed=1) if c[0] == name))
    idx = window_index_map(win, feats.shape[1])
    assert idx.shape == win.shape[:2] + (27,) and idx.dtype == torch.int32
    assert int((idx >= 0).sum()) <= window_taps(win)
    torch.testing.assert_close(subm_conv_plain(feats, idx, w),
                               window_conv_plain(feats, win, w),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def clustered():
    cfg = tiny_config()
    return cfg, clustered_rulebook_numpy(cfg, seed=0, blob=(4, 4, 2))


def test_clustered_rulebook_is_valid_and_dense(clustered):
    cfg, fields = clustered
    rb = fields["rulebook"]
    caps = cfg.model.lidar.max_voxels_per_stage
    valid = fields["voxel_valid"][0]
    coords = fields["voxel_coords"][0]
    n = int(valid.sum())
    assert 0 < n <= caps[0] and valid[:n].all() and not valid[n:].any()
    nx, ny, nz = cfg.data.point_cloud.grid_size
    assert (coords[:n] >= 0).all() and (coords[:n] < (nz, ny, nx)).all()
    assert len(np.unique(coords[:n], axis=0)) == n       # one row per voxel
    assert (coords[n:] == -1).all()
    # stage 0 in key order; a window word at (dz, dy) = (0, 0) with slot
    # code 1 at dx = 0 is the row itself
    order = rb["order_0"][0]
    np.testing.assert_array_equal(np.sort(order), np.arange(caps[0]))
    win = rb["win_0"][0]
    rows = np.arange(n)
    centre = win[:n, 4]
    assert ((centre >> 22) & 3 != 3).all()
    np.testing.assert_array_equal((centre & 0xFFFFF) - 1 + ((centre >> 22) & 3),
                                  rows)
    # a neighbour one step along x is the next or previous key
    key = (coords[order[:n], 0].astype(np.int64) * ny
           + coords[order[:n], 1]) * nx + coords[order[:n], 2]
    assert (np.diff(key) > 0).all()
    right = (centre >> 24) & 3
    has = right != 3
    src = (centre & 0xFFFFF) - 1 + right
    np.testing.assert_array_equal(key[src[has]], key[rows[has]] + 1)
    for k in range(4):
        w = rb[f"win_{k}"][0]
        assert w.shape == (caps[k], 9) and w.dtype == np.int32
    # neighbours everywhere: at least 9 of the 27 taps per occupied row
    assert window_taps(rb["win_0"]) >= 9 * n


@pytest.mark.parametrize("key,table_stage", [("win_0", 0), ("dwin_1", 0),
                                             ("win_1", 1), ("win_2", 2)])
def test_window_conv_matches_xla_on_the_clustered_rulebook(clustered, key,
                                                           table_stage):
    cfg, fields = clustered
    win = fields["rulebook"][key][0]
    m = cfg.model.lidar.max_voxels_per_stage[table_stage]
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(m, 16)).astype(np.float32)
    w = (rng.normal(size=(27, 16, 32)) * 0.1).astype(np.float32)
    assert window_taps(win) > 0
    assert_close(_port_conv(feats, win, w), _jax_conv(feats, win, w), TOL,
                 f"clustered {key}")
