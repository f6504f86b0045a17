"""Port kernel 1 (ops/kernels/stem_conv.py) against the JAX stem.

On the CPU the wrapper runs the plain version, which is held to the XLA
reference ``_stem_ref_s2d`` at f32 summation-order tolerance (1e-5 of the
largest value) and to the Pallas kernel in interpret mode at 1e-3, the bound
the JAX package's own test uses for that kernel's bf16 product split. The
CUDA kernel is held to the plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models.i3d import _s2d_prep, _stem_ref_s2d
from multimodal_gar_tpu.ops.pallas.stem_conv import stem_conv_pallas
from multimodal_gar_tpu_torch.models.i3d import s2d_prep
from multimodal_gar_tpu_torch.ops.kernels.stem_conv import (
    check_s2d_weights, even_rows, row_width, s2d_zero_taps, stem_conv,
    stem_conv_plain)
from multimodal_gar_tpu_torch.utils.testing import (STEM_EDGE_SHAPES,
                                                    stem_inputs_numpy)
from tests.test_torch_common import assert_close


def _inputs(shape, seed):
    """Seeded inputs with a valid space-to-depth w2 (zero taps zero)."""
    return stem_inputs_numpy(shape, seed)


def _ncdhw_to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 4, 1).numpy()


def test_stem_plain_matches_xla_reference():
    xd, w2, sc, bi = _inputs((1, 15, 19, 132, 12), 0)
    ref = _stem_ref_s2d(jnp.asarray(xd), jnp.asarray(w2), jnp.asarray(sc),
                        jnp.asarray(bi))
    got = stem_conv_plain(*map(torch.from_numpy, (xd, w2, sc, bi)))
    assert got.shape == (1, 64, 8, 16, 129)
    assert_close(_ncdhw_to_ndhwc(got), ref, 1e-5, "stem vs _stem_ref_s2d")


def test_stem_plain_matches_pallas_interpret():
    xd, w2, sc, bi = _inputs((1, 15, 19, 132, 12), 1)
    ref = stem_conv_pallas(jnp.asarray(xd), jnp.asarray(w2),
                           scale=jnp.asarray(sc), bias=jnp.asarray(bi),
                           interpret=True)
    got = stem_conv_plain(*map(torch.from_numpy, (xd, w2, sc, bi)))
    assert_close(_ncdhw_to_ndhwc(got), ref, 1e-3, "stem vs Pallas")


def test_stem_plain_asymmetric_temporal_pad():
    """Even T: TF-SAME pads (2, 3) on T, the case the Pallas kernel leaves
    to XLA."""
    xd, w2, sc, bi = _inputs((2, 6, 11, 70, 12), 2)
    conv = jax.lax.conv_general_dilated(
        jnp.asarray(xd), jnp.asarray(w2), (2, 1, 1), [(2, 3), (0, 0), (0, 0)],
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    ref = jnp.maximum(conv * sc + bi, 0.0)
    got = stem_conv_plain(*map(torch.from_numpy, (xd, w2, sc, bi)),
                          t_pad=(2, 3))
    assert_close(_ncdhw_to_ndhwc(got), ref, 1e-5, "stem, pad (2, 3)")


def test_s2d_prep_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 13, 18, 3)).astype(np.float32)
    w = rng.normal(size=(7, 7, 7, 3, 64)).astype(np.float32)
    jxd, jw2 = _s2d_prep(jnp.asarray(x), jnp.asarray(w))
    xd, w2 = s2d_prep(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(jxd))
    np.testing.assert_array_equal(w2.numpy(), np.asarray(jw2))


def test_stem_wrapper_takes_the_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs((1, 5, 9, 20, 12), 4)]
    before = stem_conv.launches
    with torch.no_grad():
        got = stem_conv(*args)
    torch.testing.assert_close(got, stem_conv_plain(*args), rtol=0, atol=0)
    assert stem_conv.launches == before          # counts kernel launches only


def test_stem_wrapper_checks_its_inputs():
    xd, w2, sc, bi = [torch.from_numpy(a)
                      for a in _inputs((1, 5, 9, 20, 12), 5)]
    with pytest.raises(RuntimeError, match="forward-only"):
        stem_conv(xd, w2.requires_grad_(), sc, bi)
    w2 = w2.detach()
    with pytest.raises(ValueError):
        stem_conv(xd[..., :8], w2, sc, bi)
    with pytest.raises(TypeError):
        stem_conv(xd.double(), w2, sc, bi)


@pytest.mark.parametrize("shape,t_pad", STEM_EDGE_SHAPES)
def test_stem_plain_matches_xla_at_the_kernel_edge_shapes(shape, t_pad):
    """The shapes tests/test_torch_cuda.py runs through the kernel (ragged
    row tile, W edge tile, asymmetric temporal pads), plain version against
    XLA's conv."""
    xd, w2, sc, bi = _inputs(shape, 6)
    conv = jax.lax.conv_general_dilated(
        jnp.asarray(xd), jnp.asarray(w2), (2, 1, 1),
        [tuple(t_pad), (0, 0), (0, 0)],
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    ref = jnp.maximum(conv * sc + bi, 0.0)
    with torch.no_grad():
        got = stem_conv(*map(torch.from_numpy, (xd, w2, sc, bi)),
                        t_pad=t_pad)
    assert_close(_ncdhw_to_ndhwc(got), ref, 1e-5, f"stem {shape} {t_pad}")


def test_s2d_zero_taps_are_the_zeros_of_s2d_prep():
    """The structurally zero entries the kernel skips are exactly the ones
    s2d_prep (and the JAX package's) leaves zero: 45 of the 192 (kh, kw,
    channel) rows, so 147 = 7 * 7 * 3 remain."""
    w = np.random.default_rng(7).uniform(1, 2, (7, 7, 7, 3, 64)
                                         ).astype(np.float32)
    _, jw2 = _s2d_prep(jnp.zeros((1, 1, 8, 8, 3)), jnp.asarray(w))
    zero = np.asarray(jw2 == 0).all(axis=(0, 4))
    mask = s2d_zero_taps().numpy()
    np.testing.assert_array_equal(mask, zero)
    assert mask.sum() == 192 - 147


def test_stem_wrapper_refuses_a_w2_that_is_no_s2d_weight():
    xd, w2, sc, bi = [torch.from_numpy(a)
                      for a in _inputs((1, 5, 9, 20, 12), 8)]
    check_s2d_weights(w2)
    check_s2d_weights(w2)                       # remembered: no second read
    bad = w2.clone()
    bad[2, 3, 1, 7, 5] = 0.25                   # kh = 3, eh = 1: 7x7 row 7
    with torch.no_grad():
        with pytest.raises(ValueError, match="space-to-depth"):
            stem_conv(xd, bad, sc, bi)
        w2[0, 0, 3, 4, 0] = 0.5                 # in place: kw = 3, ew = 1
        with pytest.raises(ValueError, match="space-to-depth"):
            stem_conv(xd, w2, sc, bi)
        # a caller that vouches for w2 is not checked
        got = stem_conv(xd, bad, sc, bi, w2_is_s2d=True)
    assert got.shape == (1, 64, 3, 6, 17)


# The bf16 kernel's host side (csrc/stem_conv.cu: mgar_stem_conv_bf16): its
# input rows of an even width.

@pytest.mark.parametrize("width", [18, 20])
def test_s2d_prep_even_width_matches_jax(width):
    """s2d_prep(even_width=True) gives the JAX package's xd on the real
    columns, as the first pixels of rows of an even width (W 20 makes 13
    s2d pixels: one zero pixel more in each row)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 3, 13, width, 3)).astype(np.float32)
    w = rng.normal(size=(7, 7, 7, 3, 64)).astype(np.float32)
    jxd, jw2 = _s2d_prep(jnp.asarray(x), jnp.asarray(w))
    xd, w2 = s2d_prep(torch.from_numpy(x), torch.from_numpy(w),
                      even_width=True)
    assert row_width(xd) % 2 == 0 and row_width(xd) - xd.shape[3] in (0, 1)
    np.testing.assert_array_equal(xd.numpy(), np.asarray(jxd))
    np.testing.assert_array_equal(w2.numpy(), np.asarray(jw2))


def test_even_rows_copies_only_an_odd_width():
    xd = torch.randn(2, 3, 5, 7, 12)
    rows, width = even_rows(xd)
    assert width == 8 and row_width(rows) == 8 and torch.equal(rows, xd)
    again, width = even_rows(rows)
    assert width == 8 and again.data_ptr() == rows.data_ptr()
    even = torch.randn(1, 2, 3, 6, 12)
    assert even_rows(even)[0].data_ptr() == even.data_ptr()
    assert row_width(xd.transpose(2, 3)) is None
