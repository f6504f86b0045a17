"""The gather-probe tool of the port against the JAX side at small sizes.

``tools/probe_gather.py`` builds its kernels as closures inside functions
that launch on a TPU, so the kernel bodies are restated here (same
statements, sizes as arguments) and run through ``pl.pallas_call(...,
interpret=True)`` on the CPU. The port's wrappers take their plain versions
on CPU tensors; those are what is compared.

- gathers (probes A and E): exact equality, also against the numpy
  reference of the original (``tab[idx[:, 0]]``);
- gather + GEMM probes (B against probe C's gather + einsum, F): float32
  sums in another order, rtol 1e-5 of the largest reference value;
- the tool's ``main`` runs every probe on the CPU, and a probe that raises
  fails it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodal_gar_tpu_torch.ops.kernels.row_gather import (row_gather,
                                                             row_gather_plain)
from multimodal_gar_tpu_torch.ops.kernels.subm_conv import subm_conv
from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
    window_conv_shifted, window_conv_shifted_plain)
from multimodal_gar_tpu_torch.tools import probe_gather as tool
from tests.test_torch_common import assert_close

M, C, D, K3, RB = 256, 32, 32, 27, 64
GEMM_TOL = 1e-5


def _inputs(m=M, c=C, d=D, k3=K3, seed=0):
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(m, c)).astype(np.float32)
    idx = rng.integers(0, m, (m, k3)).astype(np.int32)
    w = rng.normal(size=(k3, c, d)).astype(np.float32) * 0.1
    return tab, idx, w


def _interpret(kern, out_shape, *args, grid=(), in_specs=None,
               out_specs=None):
    kw = {}
    if in_specs is not None:
        kw = dict(grid=grid, in_specs=in_specs, out_specs=out_specs)
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True, **kw)(*map(jnp.asarray, args)))


def test_probe_a_row_gather_matches_in_kernel_take():
    """probe_a's kernel body (tools/probe_gather.py:73-75) in interpret
    mode, against row_gather on the same table and indices: exact."""
    tab, idx, _ = _inputs()

    def kern(tab_ref, idx_ref, o_ref):
        g = jnp.take(tab_ref[...], idx_ref[...].reshape(-1), axis=0)
        o_ref[...] = g.reshape(RB, K3 * C)

    ref = _interpret(
        kern, (M, K3 * C), tab, idx, grid=(M // RB,),
        in_specs=[pl.BlockSpec((M, C), lambda i: (0, 0)),
                  pl.BlockSpec((RB, K3), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((RB, K3 * C), lambda i: (i, 0)))
    got = row_gather(torch.from_numpy(tab), torch.from_numpy(idx))
    assert got.shape == (M, K3 * C)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx),
                                         axis=0)).reshape(M, K3 * C))


@pytest.mark.parametrize("m,width", [(256, 32), (256, 48), (256, 128),
                                     (640, 48)])
def test_probe_e_row_gather_matches_take_along_axis(m, width):
    """probe_e's kernel body (tools/probe_gather.py:215-217) in interpret
    mode and its numpy reference (:245), against row_gather at K = 1:
    exact."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(m, width)).astype(np.float32)
    idx = rng.integers(0, m, (m, 1)).astype(np.int32)

    def kern(tab_ref, idx_ref, o_ref):
        idx2d = jnp.broadcast_to(idx_ref[...], tab_ref.shape)
        o_ref[...] = jnp.take_along_axis(tab_ref[...], idx2d, axis=0)

    ref = _interpret(kern, (m, width), tab, idx)
    got = row_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tab[idx[:, 0]])


def test_probe_b_subm_conv_matches_gather_einsum():
    """The B path (K3 at B = 1) against probe_b's kernel body
    (tools/probe_gather.py:104-110) in interpret mode and probe_c's gather +
    einsum (:142-144)."""
    tab, idx, w = _inputs()

    def kern(tab_ref, idx_ref, w_ref, o_ref):
        t = tab_ref[...]
        acc = jnp.zeros((RB, D), jnp.float32)
        for k in range(K3):
            g = jnp.take(t, idx_ref[:, k], axis=0)
            acc += jnp.dot(g, w_ref[k], preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        o_ref[...] = acc

    pallas = _interpret(
        kern, (M, D), tab, idx, w, grid=(M // RB,),
        in_specs=[pl.BlockSpec((M, C), lambda i: (0, 0)),
                  pl.BlockSpec((RB, K3), lambda i: (i, 0)),
                  pl.BlockSpec((K3, C, D), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((RB, D), lambda i: (i, 0)))
    xla = np.asarray(jnp.einsum(
        "mkc,kcd->md", jnp.asarray(tab)[jnp.asarray(idx)], jnp.asarray(w),
        precision=jax.lax.Precision.HIGHEST))
    t, i, wt = (torch.from_numpy(a) for a in (tab, idx, w))
    got = subm_conv(t[None], i[None], wt)[0].numpy()
    assert_close(got, xla, GEMM_TOL, "subm_conv vs gather + einsum")
    assert_close(got, pallas, GEMM_TOL, "subm_conv vs probe_b's body")
    assert_close(tool.gather_einsum(t, i, wt).numpy(), xla, GEMM_TOL,
                 "the tool's probe C function")


def _probe_f_inputs(m=M, c=C, d=D):
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(m, 3 * c)).astype(np.float32)
    pos = rng.integers(0, m, (m, 9)).astype(np.int32)
    sel = rng.integers(0, 64, (m, 9)).astype(np.int32)
    w = rng.normal(size=(27, c, d)).astype(np.float32) * 0.1
    return tab, pos, sel, w


def test_probe_f_shifted_window_conv_matches_kernel_body():
    """probe_f's kernel body (tools/probe_gather.py:259-274) in interpret
    mode against window_conv_shifted."""
    m, c, d = M, C, D
    tab, pos, sel, w = _probe_f_inputs()

    def kern(wt_ref, pos_ref, sel_ref, w_ref, o_ref):
        wt = wt_ref[...]
        acc = jnp.zeros((m, d), jnp.float32)
        for p in range(9):
            idx2d = jnp.broadcast_to(pos_ref[:, p][:, None], wt.shape)
            g = jnp.take_along_axis(wt, idx2d, axis=0)
            g3 = g.reshape(m, 3, c)
            slot = (sel_ref[:, p][:, None] >> (2 * jnp.arange(3))) & 3
            for wdx in range(3):
                onehot = (slot[:, wdx][:, None]
                          == jnp.arange(3)).astype(jnp.float32)
                tap = jnp.einsum("mjc,mj->mc", g3, onehot,
                                 precision=jax.lax.Precision.HIGHEST)
                acc += jnp.dot(tap, w_ref[p * 3 + wdx],
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)
        o_ref[...] = acc

    ref = _interpret(kern, (m, d), tab, pos, sel, w)
    args = [torch.from_numpy(a) for a in (tab, pos, sel, w)]
    got = window_conv_shifted(*args).numpy()
    assert_close(got, ref, GEMM_TOL, "window_conv_shifted vs probe_f's body")
    np.testing.assert_array_equal(
        got, window_conv_shifted_plain(*args).numpy())
    # slot 3 contributes zero: with every select at 63 the output is zero
    none = torch.full_like(args[2], 63)
    assert not window_conv_shifted(args[0], args[1], none, args[3]).any()


def test_row_gather_contract():
    """Out-of-range indices raise on the CPU path (the kernel writes zero
    rows instead, tests/test_torch_cuda.py); widths, types and devices are
    checked; launches count only kernel launches."""
    tab = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([[0, 9], [3, 3]], dtype=torch.int32)
    before = row_gather.launches
    out = row_gather(tab, idx)
    assert torch.equal(out, torch.cat([tab[[0, 3]], tab[[9, 3]]], 1))
    assert row_gather.launches == before
    for bad in (-1, 10):
        with pytest.raises(IndexError):
            row_gather(tab, torch.tensor([[bad]], dtype=torch.int32))
    with pytest.raises(ValueError):
        row_gather(torch.zeros((4, 6)), idx)            # width % 4
    with pytest.raises(TypeError):
        row_gather(tab, idx.long())
    with pytest.raises(TypeError):
        row_gather(tab.double(), idx)
    assert torch.equal(row_gather_plain(tab, idx), out)


def test_window_conv_shifted_contract():
    tab, pos, sel, w = (torch.from_numpy(a)
                        for a in _probe_f_inputs(m=16, c=8, d=8))
    assert window_conv_shifted(tab, pos, sel, w).shape == (16, 8)
    with pytest.raises(ValueError):
        window_conv_shifted(tab[:, :16], pos, sel, w)   # not (M, 3C)
    with pytest.raises(ValueError):
        window_conv_shifted(tab, pos[:, :8], sel, w)    # not (R, 9)
    with pytest.raises(TypeError):
        window_conv_shifted(tab, pos.long(), sel, w)
    with pytest.raises(RuntimeError):
        window_conv_shifted(tab, pos, sel, w.requires_grad_())


def test_probe_functions_return_their_numbers_at_small_sizes():
    dev = torch.device("cpu")
    with torch.inference_mode():
        assert tool.probe_c(dev, 64)["ms"] > 0
        rows = tool.probe_d(dev, 64, pairs=((27, 16), (9, 48)))
        assert [(r["rows"], r["width"]) for r in rows] == [(27, 16), (9, 48)]
        assert set(tool.probe_a(dev, 64)) == {"ms", "plain_ms"}
        assert tool.probe_b(dev, 64)["rel_err"] <= tool.GEMM_TOL
        assert tool.probe_w(dev, 64)["rel_err"] <= tool.GEMM_TOL
        e = tool.probe_e(dev, tool.e_shapes(64))
        assert [(r["m"], r["width"]) for r in e] == [(64, 32), (64, 48),
                                                     (64, 128), (160, 48)]
        assert all(r["max_err"] == 0.0 for r in e)
        assert tool.probe_f(dev, 64)["rel_err"] <= tool.GEMM_TOL
    assert tool.e_shapes() == ((16384, 32), (16384, 48), (16384, 128),
                               (40960, 48))
    assert (tool.M, tool.C, tool.D, tool.K3) == (16384, 32, 32, 27)


def test_main_runs_every_probe_on_the_cpu(capsys):
    assert tool.main(["--device", "cpu", "--rows", "256"]) == 0
    out = capsys.readouterr().out
    for letter in "CDABWEF":
        assert f"\n{letter}: " in out, letter
    assert out.count("\nD: ") == 6 and out.count("\nE: ") == 4


def test_main_fails_when_a_probe_raises(monkeypatch):
    """Unlike the original's main(), which catches every probe's exception
    and carries on (tools/probe_gather.py:301-305)."""
    def broken(*args, **kwargs):
        raise RuntimeError("probe E broke")
    monkeypatch.setattr(tool, "probe_e", broken)
    with pytest.raises(RuntimeError, match="probe E broke"):
        tool.main(["--device", "cpu", "--rows", "64"])


def test_main_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--rows", "64"])
