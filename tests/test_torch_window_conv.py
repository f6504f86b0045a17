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
