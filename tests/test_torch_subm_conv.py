"""Port kernels 3 (ops/kernels/subm_conv.py) and 4
(ops/kernels/sparse_wgrad.py), plain versions, against the JAX package.

- K3 against ``subm_conv_xla`` to 1e-6 relative (the same float32 products
  summed in another order), on rulebook maps (R = M for ``nbr_k``, R != M
  for ``down_k``) and on random maps;
- K3 against ``subm_conv_pallas`` in interpret mode, within that test's own
  bound for its bf16 one-hot products (tests/test_pallas.py:8-17,
  rtol = atol = 2e-2);
- K4 against ``jax.grad`` of the gather + einsum to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.ops.pallas import subm_conv_pallas, subm_conv_xla
from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
    sparse_wgrad, sparse_wgrad_plain)
from multimodal_gar_tpu_torch.ops.kernels.subm_conv import (subm_conv,
                                                            subm_conv_plain)
from tests.test_torch_common import assert_close
from tests.test_torch_window_conv import _scene


def _port(table, idx, w):
    return subm_conv_plain(torch.from_numpy(table)[None],
                           torch.from_numpy(idx)[None],
                           torch.from_numpy(w))[0].numpy()


@pytest.mark.parametrize("key", ["nbr_0", "nbr_2", "down_1", "down_3"])
def test_subm_conv_plain_matches_xla_on_rulebook_maps(key):
    rng, cap, rb = _scene((6, 10, 12), 5, 0.5)
    idx = rb[key]
    table = rng.normal(size=(cap, 16)).astype(np.float32)
    w = (rng.normal(size=(27, 16, 32)) * 0.1).astype(np.float32)
    assert np.any(idx >= 0) and np.any(idx < 0)
    assert_close(_port(table, idx, w),
                 subm_conv_xla(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(w)), 1e-6, key)


def test_subm_conv_plain_matches_xla_rows_differ_from_table():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(300, 32)).astype(np.float32)
    idx = rng.integers(-1, 300, (170, 27)).astype(np.int32)
    w = rng.normal(size=(27, 32, 16)).astype(np.float32)
    got = _port(table, idx, w)
    assert got.shape == (170, 16)
    assert_close(got, subm_conv_xla(jnp.asarray(table), jnp.asarray(idx),
                                    jnp.asarray(w)), 1e-6, "R != M")


def test_subm_conv_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    m, c, d = 128, 16, 16
    feats = rng.normal(size=(m, c)).astype(np.float32)
    nbr = rng.integers(-1, m, (m, 27)).astype(np.int32)
    w = (rng.normal(size=(27, c, d)) * 0.1).astype(np.float32)
    ref = subm_conv_pallas(jnp.asarray(feats), jnp.asarray(nbr),
                           jnp.asarray(w), block_m=64)
    np.testing.assert_allclose(_port(feats, nbr, w), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)   # bf16 in the kernel


def test_sparse_wgrad_plain_matches_jax_grad():
    rng = np.random.default_rng(2)
    b, m, r, c, d = 2, 90, 70, 16, 32
    table = rng.normal(size=(b, m, c)).astype(np.float32)
    idx = rng.integers(-1, m, (b, r, 27)).astype(np.int32)
    dout = rng.normal(size=(b, r, d)).astype(np.float32)

    def conv(w):
        return jnp.stack([subm_conv_xla(jnp.asarray(table[i]),
                                        jnp.asarray(idx[i]), w)
                          for i in range(b)])

    _, vjp = jax.vjp(conv, jnp.zeros((27, c, d), jnp.float32))
    ref, = vjp(jnp.asarray(dout))
    got = sparse_wgrad_plain(torch.from_numpy(table), torch.from_numpy(idx),
                             torch.from_numpy(dout))
    assert_close(got.numpy(), ref, 1e-5, "dW")


def test_wrappers_take_the_plain_versions_on_cpu_and_check_inputs():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(1, 40, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 40, (1, 30, 27)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(27, 16, 32)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(1, 30, 32)).astype(np.float32))
    k3, k4 = subm_conv.launches, sparse_wgrad.launches
    with torch.no_grad():
        torch.testing.assert_close(subm_conv(table, idx, w),
                                   subm_conv_plain(table, idx, w),
                                   rtol=0, atol=0)
        torch.testing.assert_close(sparse_wgrad(table, idx, dout),
                                   sparse_wgrad_plain(table, idx, dout),
                                   rtol=0, atol=0)
    assert (subm_conv.launches, sparse_wgrad.launches) == (k3, k4)
    with pytest.raises(TypeError):
        subm_conv(table, idx.long(), w)
    with pytest.raises(ValueError):
        subm_conv(table, idx[..., :9], w)
    with pytest.raises(ValueError):
        sparse_wgrad(table, idx, dout[:, :10])
    with pytest.raises(RuntimeError, match="explicit maps"):
        subm_conv(table, idx, w.clone().requires_grad_())
