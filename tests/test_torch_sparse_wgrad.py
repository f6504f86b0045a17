"""The edge cases of the sparse weight gradient (ops/kernels/sparse_wgrad.py)
and of the row gather (ops/kernels/row_gather.py), plain versions, against
the JAX package on the CPU.

The cases are the tables ``WGRAD_EDGE_CASES`` and ``ROW_GATHER_EDGE_CASES``
of the port's utils/testing.py; tests/test_torch_cuda.py holds the CUDA
kernels to the plain versions on the same inputs.

- ``sparse_wgrad_plain`` against ``jax.vjp`` of ``subm_conv_xla`` with
  respect to the weights, to 1e-5 of the largest value (the same float32
  products summed in another order);
- ``row_gather`` against ``jnp.take``, exactly; an index outside [0, M)
  raises on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.ops.pallas import subm_conv_xla
from multimodal_gar_tpu_torch.ops.kernels.row_gather import (row_gather,
                                                             row_gather_plain)
from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
    SUPPORTED, sparse_wgrad, sparse_wgrad_plain)
from multimodal_gar_tpu_torch.utils.testing import (ROW_GATHER_EDGE_CASES,
                                                    WGRAD_EDGE_CASES,
                                                    row_gather_edge_inputs,
                                                    wgrad_edge_inputs)
from tests.test_torch_common import assert_close


def _jax_wgrad(table, idx, dout):
    c, d = table.shape[-1], dout.shape[-1]

    def conv(w):
        return jnp.stack([subm_conv_xla(jnp.asarray(table[i]),
                                        jnp.asarray(idx[i]), w)
                          for i in range(table.shape[0])])

    _, vjp = jax.vjp(conv, jnp.zeros((27, c, d), jnp.float32))
    return np.asarray(vjp(jnp.asarray(dout))[0])


@pytest.mark.parametrize("name", sorted(WGRAD_EDGE_CASES))
def test_sparse_wgrad_plain_matches_jax_vjp_on_edge_cases(name):
    table, idx, dout = wgrad_edge_inputs(name)
    ref = _jax_wgrad(table, idx, dout)
    launches = sparse_wgrad.launches
    with torch.no_grad():
        got = sparse_wgrad(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(dout)).numpy()
    assert sparse_wgrad.launches == launches        # CPU: the plain version
    assert got.shape == ref.shape == (27, table.shape[-1], dout.shape[-1])
    if name == "all rows padding":
        assert not got.any() and not ref.any()
        return
    assert_close(got, ref, 1e-5, name)
    absent = (idx < 0).all(axis=(0, 1))             # taps no row has
    assert not got[absent].any()
    if name == "only the centre tap":
        assert absent.sum() == 26 and got[13].any()


def test_wgrad_edge_cases_cover_every_supported_pair():
    pairs = {(c, d) for _, _, _, c, d in WGRAD_EDGE_CASES.values()}
    assert pairs == set(SUPPORTED)


@pytest.mark.parametrize("name", sorted(ROW_GATHER_EDGE_CASES))
def test_row_gather_matches_jnp_take_on_edge_cases(name):
    table, idx, want = row_gather_edge_inputs(name)
    m, c, r, k = ROW_GATHER_EDGE_CASES[name]
    inside = bool(((idx >= 0) & (idx < m)).all())
    tab_t, idx_t = torch.from_numpy(table), torch.from_numpy(idx)
    if not inside:
        with pytest.raises(IndexError):
            row_gather(tab_t, idx_t)
        # the rows in range are what jnp.take gives; the others are zeros
        rows = ((idx >= 0) & (idx < m))[:, 0]
        take = np.asarray(jnp.take(jnp.asarray(table),
                                   jnp.asarray(idx[rows, 0]), axis=0))
        np.testing.assert_array_equal(want[rows], take)
        assert not want[~rows].any() and (~rows).sum() == 5
        return
    take = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx),
                               axis=0)).reshape(r, k * c)
    got = row_gather(tab_t, idx_t)
    assert torch.equal(got, row_gather_plain(tab_t, idx_t))
    np.testing.assert_array_equal(got.numpy(), take)
    np.testing.assert_array_equal(want, take)
