"""The backward of the port's sparse convs against the JAX package.

- The explicit maps of ops/sparse_maps.py (nbr_k / down_k remapped into the
  x-window path's key-sorted row order) gather exactly what
  ``window_gather`` decodes from the packed maps, for every layer, and the
  strided inverse maps invert their forward maps exactly.
- d(features) and d(weights) of the sparse conv autograd (the x-window and
  the nbr-map forward, both differentiated through K3 and K4, here their
  plain versions) against ``jax.vjp`` of ``window_gather`` + einsum, and of
  the nbr-map gather + einsum, for all 11 layer kinds of VoxelBackbone8x at
  their real widths, to 1e-5 relative (float32 sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models.sparse_backbone import (
    window_gather as jax_window_gather)
from multimodal_gar_tpu.ops.pallas import subm_conv_xla
from multimodal_gar_tpu_torch.ops.kernels.subm_conv import subm_conv
from multimodal_gar_tpu_torch.ops.kernels.window_conv import (window_conv,
                                                              window_gather)
from multimodal_gar_tpu_torch.ops.sparse_maps import (backbone_maps,
                                                      gather_taps)
from multimodal_gar_tpu_torch.utils.testing import (synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import assert_close

TOL = 1e-5
# VoxelBackbone8x: (layer, window map, explicit map, stage of the table,
# C, D)
LAYERS = (
    ("conv_input", "win_0", "nbr_0", 0, 4, 16),
    ("conv1_0", "win_0", "nbr_0", 0, 16, 16),
    ("conv2_down", "dwin_1", "down_1", 0, 16, 32),
    ("conv2_1", "win_1", "nbr_1", 1, 32, 32),
    ("conv2_2", "win_1", "nbr_1", 1, 32, 32),
    ("conv3_down", "dwin_2", "down_2", 1, 32, 64),
    ("conv3_1", "win_2", "nbr_2", 2, 64, 64),
    ("conv3_2", "win_2", "nbr_2", 2, 64, 64),
    ("conv4_down", "dwin_3", "down_3", 2, 64, 64),
    ("conv4_1", "win_3", "nbr_3", 3, 64, 64),
    ("conv4_2", "win_3", "nbr_3", 3, 64, 64),
)


@pytest.fixture(scope="module")
def rulebook():
    fields = synthetic_batch_numpy(tiny_config(), batch_size=2, seed=0)
    rb = fields["rulebook"]
    caps = tiny_config().model.lidar.max_voxels_per_stage
    return rb, {k: torch.from_numpy(v) for k, v in rb.items()}, caps


def test_explicit_maps_equal_the_decoded_window_taps(rulebook):
    rb, trb, caps = rulebook
    maps = backbone_maps(trb, key_sorted=True)
    rng = np.random.default_rng(0)
    for name, win_key, map_key, stage, c, _ in LAYERS:
        table = torch.from_numpy(
            rng.normal(size=(2, caps[stage], c)).astype(np.float32))
        ref = window_gather(table, trb[win_key])
        got = gather_taps(table, maps[map_key].fwd)
        assert torch.equal(got, ref), name
        assert torch.count_nonzero(ref) > 0, name


def test_strided_inverse_maps_invert_their_forward_maps(rulebook):
    _, trb, caps = rulebook
    for key_sorted in (True, False):
        maps = backbone_maps(trb, key_sorted=key_sorted)
        for k in (1, 2, 3):
            m = maps[f"down_{k}"]
            down, up = m.fwd.long(), m.bwd.long()
            assert up.shape == (2, caps[k - 1], 27) and not m.mirrored
            b, o, t = torch.nonzero(down >= 0, as_tuple=True)
            assert torch.equal(up[b, down[b, o, t], t], o)
            assert int((up >= 0).sum()) == len(o)
        for k in range(4):
            m = maps[f"nbr_{k}"]
            assert m.mirrored and m.bwd is m.fwd


def _inputs(name, stage, c, d, rows, caps):
    rng = np.random.default_rng(len(name))
    feats = rng.normal(size=(2, caps[stage], c)).astype(np.float32)
    w = (rng.normal(size=(27, c, d)) / np.sqrt(27 * c)).astype(np.float32)
    dout = rng.normal(size=(2, rows, d)).astype(np.float32)
    return feats, w, dout


@pytest.fixture(scope="module")
def jax_grads(rulebook):
    """{(layer, x-window?): (d feats, d w)} of jax.vjp of the per-item
    window_gather + einsum (x-window) or nbr-map gather + einsum, all
    layers in one jit."""
    rb, _, caps = rulebook

    def vjp(window, maps, feats, w, dout):
        def conv(f, wt):
            if window:
                return jnp.stack([jnp.einsum(
                    "rkc,kcd->rd", jax_window_gather(f[i], maps[i]), wt)
                    for i in range(f.shape[0])])
            return jnp.stack([subm_conv_xla(f[i], maps[i], wt)
                              for i in range(f.shape[0])])
        return jax.vjp(conv, feats, w)[1](dout)

    def all_layers(args):
        return {key: vjp(key[1], *a) for key, a in args.items()}

    args = {}
    for name, win_key, map_key, stage, c, d in LAYERS:
        inputs = _inputs(name, stage, c, d, rb[win_key].shape[1], caps)
        for window in (True, False):
            maps = rb[win_key if window else map_key]
            args[(name, window)] = tuple(jnp.asarray(x)
                                         for x in (maps,) + inputs)
    return jax.jit(all_layers)(args)


@pytest.mark.parametrize("name,win_key,map_key,stage,c,d", LAYERS,
                         ids=[layer[0] for layer in LAYERS])
def test_sparse_conv_backward_matches_jax_vjp(rulebook, jax_grads, name,
                                              win_key, map_key, stage, c, d):
    rb, trb, caps = rulebook
    feats, w, dout = _inputs(name, stage, c, d, rb[win_key].shape[1], caps)
    for key_sorted in (True, False):
        maps = backbone_maps(trb, key_sorted=key_sorted)[map_key]
        f = torch.from_numpy(feats).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        if key_sorted:
            out = window_conv(f, trb[win_key], wt, maps)
        else:
            out = subm_conv(f, maps.fwd, wt, maps)
        out.backward(torch.from_numpy(dout))
        ref = jax_grads[(name, key_sorted)]
        what = f"{name} ({'x-window' if key_sorted else 'nbr-map'})"
        assert_close(f.grad.numpy(), ref[0], TOL, f"{what} d(features)")
        assert_close(wt.grad.numpy(), ref[1], TOL, f"{what} d(weights)")
        assert float(np.abs(np.asarray(ref[0])).max()) > 0


def test_backward_skips_the_features_that_need_no_gradient(rulebook):
    """conv_input's voxel features: only d(weights) is formed."""
    _, trb, caps = rulebook
    maps = backbone_maps(trb, key_sorted=True)["nbr_0"]
    f = torch.ones((2, caps[0], 4))
    wt = torch.ones((27, 4, 16), requires_grad=True)
    window_conv(f, trb["win_0"], wt, maps).sum().backward()
    assert f.grad is None and wt.grad is not None
