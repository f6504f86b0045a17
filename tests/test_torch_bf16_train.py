"""The port's training at ``model.dtype: bfloat16`` against the JAX
package's VJP at bf16.

Same numpy-seeded inputs, weights (through the converter where a whole
model is loaded) and cotangents on both sides; the JAX side on the CPU, as
its own tests run it. Parameters stay float32 on both sides and every
module casts at its point of use, so autograd rounds a gradient where the
forward rounded: the backward of a cast to bf16 widens, the backward of a
cast to float32 rounds. Where XLA's VJP rounds otherwise, the port says so
in code: the sparse conv's autograd function (kernel C rounds each tap's
product, kernel D the float32 sum once), and the training BatchNorm (two
casts of a bf16 input, as flax's statistics and normalisation take it).

Tolerance, as tests/test_torch_bf16.py states it, for each output and each
gradient:
  1. within 2e-2 of its largest JAX bf16 value;
  2. where JAX's own bf16-vs-f32 gap on the same inputs is 1e-3 or more of
     the largest value, within half that gap. This is what shows that a
     gradient is rounded where JAX rounds it: for the sparse layer's
     d(features) a port that sums the taps without rounding each one lands
     past half the gap (test_unrounded_taps_miss_half_the_gap).
Bound 2 is held module by module, on each module's VJP. Through the whole
model it cannot hold: JAX's own bf16 gradients sit 0.1 to 1.1 of their
largest value from its float32 ones (BatchNorms with batch statistics at
batch 2 subtract large terms, and bf16 cancels them), and its bf16 run
against itself on inputs moved by one ulp at 0.1% of their values drifts
as far on some leaves. So the whole train step holds the losses under both
bounds, the BatchNorm statistics under bound 1, and each gradient leaf
under bound 1 wherever JAX's own drift stays below it (the leaves where
it does not are printed, with ``pytest -s``).
The plain kernel C and kernel D are held bit for bit to their definitions
computed in float64 and rounded at JAX's points.
"""
import dataclasses

import flax.linen
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu.models.i3d import Unit3D as JaxUnit3D
from multimodal_gar_tpu.models.nonlocal_block import NLBlockND as JaxNL
from multimodal_gar_tpu.models.sparse_backbone import (
    SparseConv3dDown as JaxDown, SparseTensor as JaxSparseTensor,
    SubMConv3d as JaxSubM)
from multimodal_gar_tpu.train import losses as jax_losses
from multimodal_gar_tpu_torch.convert import _target
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.models.i3d import StemUnit3D, Unit3D
from multimodal_gar_tpu_torch.models.layers import BatchNorm, dense
from multimodal_gar_tpu_torch.models.nonlocal_block import NLBlockND
from multimodal_gar_tpu_torch.models.sparse_backbone import (
    _LAYERS as SPARSE_LAYERS, SparseConv)
from multimodal_gar_tpu_torch.ops.kernels import sparse_wgrad, subm_conv
from multimodal_gar_tpu_torch.ops.sparse_maps import (ConvMaps,
                                                      backbone_maps,
                                                      gather_taps,
                                                      inverse_map)
from multimodal_gar_tpu_torch.train.losses import compute_losses, total_loss
from multimodal_gar_tpu_torch.utils.testing import (
    batch_from_numpy, condition_for_grad_parity_, prepare_grad_parity_,
    synthetic_batch_numpy, tiny_config)
from tests.test_torch_bf16 import (BF, GAP_MIN, TOL, _f32, _nudge, _rel,
                                   check_bf16)
from tests.test_torch_common import (exact_pool_config, jax_batch,
                                     port_module, random_variables, to_jax)


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held in float32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(BF).astype(
        jnp.float32))


def _jax_vjp(fn, primals, ct):
    """(output, cotangents of ``primals``) of ``fn`` at the cotangent
    ``ct`` (cast to the output's dtype), compiled."""
    def run(primals, ct):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(jnp.asarray(ct).astype(out.dtype))
    return jax.jit(run)(primals, jnp.asarray(ct))


def _check_all(got: dict, ref16: dict, ref32: dict, what: str,
               drift: dict = None) -> None:
    """check_bf16 of every output and gradient; ``drift``, where given,
    holds JAX's own bf16 run on nudged inputs, and bound 2 then applies
    where its distance from JAX's run stays below half the gap."""
    assert set(got) == set(ref16) == set(ref32)
    for key in ref16:
        check_bf16(got[key], ref16[key], ref32[key], f"{what} {key}",
                   None if drift is None
                   else _rel(_f32(drift[key]), _f32(ref16[key])))


def _port_grads(out, tensors: dict, ct: np.ndarray) -> dict:
    grads = torch.autograd.grad(out, list(tensors.values()),
                                torch.from_numpy(ct).to(out.dtype))
    return dict(zip(tensors, grads))


# ---------------------------------------------------------------------------
# The sparse layers: kernel C's and kernel D's roundings
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sparse_scene():
    """The tiny batch's stage-0/1 maps (key-sorted for the x-window path,
    as the backbone runs them), a float32 table of 16 channels (a
    BatchNorm's output, which the layer rounds), and the motivation's
    random layer: M 4000, C 32, D 64, 40% of the taps present, each
    (row, tap) feeding one output at most."""
    cfg = tiny_config()
    f = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    rb = f["rulebook"]
    m0 = rb["win_0"].shape[1]
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, m0, 16)).astype(np.float32)
    m1 = rb["coords_1"].shape[1]
    valid1 = np.arange(m1)[None, :] < rb["count_1"][:, None]
    valid0 = np.arange(m0)[None, :] < f["voxel_valid"].sum(1)[:, None]
    maps = backbone_maps({k: torch.from_numpy(v) for k, v in rb.items()},
                         key_sorted=True)
    m = 4000
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(m) for _ in range(27)], -1)[None]
    idx = np.where(rng.random((1, m, 27)) < 0.4, idx, -1).astype(np.int32)
    return dict(rb=rb, feats=feats, valid0=valid0, valid1=valid1,
                maps=maps, random_idx=idx,
                random_feats=rng.normal(size=(1, m, 32)).astype(np.float32))


def _sparse_case(s, layer):
    """(JAX conv module kwargs, its call kwargs, port win, port maps,
    features, output valid, cout) of one layer of the scene."""
    rb = s["rb"]
    if layer == "random":
        idx = s["random_idx"]
        maps = ConvMaps(torch.from_numpy(idx),
                        inverse_map(torch.from_numpy(idx), idx.shape[1]),
                        False)
        return (JaxSubM, dict(neighbor_idx=jnp.asarray(idx)), None, maps,
                s["random_feats"], np.ones(idx.shape[:2], bool), 64)
    if layer == "strided":
        kw = dict(window_pre=(jnp.asarray(rb["coords_1"]),
                              jnp.asarray(s["valid1"]),
                              jnp.asarray(rb["dwin_1"])))
        return (JaxDown, kw, torch.from_numpy(rb["dwin_1"]),
                s["maps"]["down_1"], s["feats"], s["valid1"], 32)
    if layer == "x_window":
        return (JaxSubM, dict(window=jnp.asarray(rb["win_0"])),
                torch.from_numpy(rb["win_0"]), s["maps"]["nbr_0"],
                s["feats"], s["valid0"], 16)
    # nbr-map path: the original row order, whose nbr_0 is its own mirror
    nbr = torch.from_numpy(rb["nbr_0"])
    return (JaxSubM, dict(neighbor_idx=jnp.asarray(rb["nbr_0"])), None,
            ConvMaps(nbr, nbr, True), s["feats"], s["valid0"], 16)


def _sparse_runs(s, layer):
    jcls, kw, win, maps, feats, out_valid, cout = _sparse_case(s, layer)
    cin = feats.shape[-1]
    rng = np.random.default_rng(8)
    kernel = (rng.normal(size=(27, cin, cout))
              / np.sqrt(27 * cin)).astype(np.float32)
    ct = _bf16_values(rng.normal(size=out_valid.shape + (cout,)))
    jst = JaxSparseTensor(features=jnp.asarray(feats),
                          coords=jnp.zeros(feats.shape[:2] + (3,),
                                           jnp.int32),
                          valid=jnp.asarray(s["valid0"] if layer != "random"
                                            else out_valid),
                          spatial_shape=(8, 32, 32))
    refs = []
    for dt in (BF, jnp.float32):
        mod = jcls(cout, dtype=dt)
        out, (dx, dk) = _jax_vjp(
            lambda x, k, mod=mod: mod.apply({"params": {"kernel": k}},
                                            jst.replace(features=x),
                                            **kw).features,
            (jnp.asarray(feats), jnp.asarray(kernel)), ct)
        refs.append(dict(out=out, d_features=dx, d_weights=dk))
    conv = SparseConv(cin, cout, device="cpu",
                      generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel))
    x = torch.from_numpy(feats).requires_grad_()
    out = conv(x, win, maps, torch.from_numpy(out_valid))
    got = _port_grads(out, {"d_features": x, "d_weights": conv.weight}, ct)
    got["out"] = out
    return got, refs[0], refs[1], dict(maps=maps, ct=ct, kernel=kernel)


@pytest.mark.parametrize("layer", ["x_window", "nbr_map", "strided",
                                   "random"])
def test_sparse_layer_vjp_matches_jax_bf16(sparse_scene, layer):
    """One sparse conv at bf16 and its VJP: the x-window submanifold layer
    over win_0, the nbr-map one over nbr_0, the strided one over dwin_1,
    and the motivation's random layer (M 4000, C 32, D 64): output,
    d(features) (float32, kernel C's per-tap rounding) and d(weights)
    (kernel D's one rounding, widened to the float32 parameter)."""
    got, ref16, ref32, _ = _sparse_runs(sparse_scene, layer)
    assert got["out"].dtype == torch.bfloat16
    assert got["d_features"].dtype == torch.float32
    assert got["d_weights"].dtype == torch.float32
    assert ref16["d_features"].dtype == jnp.float32
    if layer == "random":
        # its 256k outputs, each one float32 sum rounded to bf16 (the
        # forward of tests/test_torch_bf16.py), are held to bound 1 only:
        # where two sums in other orders straddle a rounding point they
        # land one bf16 ulp apart, and one ulp of a value near the largest
        # is about twice half the gap, which is half an ulp there
        out = (got.pop("out"), ref16.pop("out"), ref32.pop("out"))
        assert _rel(_f32(out[0]), _f32(out[1])) <= TOL
    _check_all(got, ref16, ref32, f"{layer} layer")
    # d(weights) is a bf16 value widened, as JAX's
    dw = got["d_weights"]
    assert torch.equal(dw, dw.bfloat16().float())


def test_unrounded_taps_miss_half_the_gap(sparse_scene):
    """Why kernel C rounds each tap: on the random layer a d(features)
    that sums the taps' exact products and rounds nothing lies past half
    JAX's own bf16-vs-f32 gap, where the port's lies within it."""
    got, ref16, ref32, aux = _sparse_runs(sparse_scene, "random")
    maps = aux["maps"]
    dout = torch.from_numpy(aux["ct"]).double()
    wt = maps.dgrad_weights(torch.from_numpy(aux["kernel"]).bfloat16())
    unrounded = torch.einsum("brkd,kdc->brc", gather_taps(dout, maps.bwd),
                             wt.double()).float()
    gap = _rel(_f32(ref16["d_features"]), _f32(ref32["d_features"]))
    assert gap >= GAP_MIN
    assert _rel(_f32(got["d_features"]), _f32(ref16["d_features"])) \
        <= gap / 2
    assert _rel(unrounded.numpy(), _f32(ref16["d_features"])) > gap / 2


def _kernel_c_cluster_sums(dout: np.ndarray, idx: np.ndarray,
                           wt: np.ndarray, clusters: int) -> np.ndarray:
    """Kernel C's sum order on the card (csrc/subm_conv.cu), in numpy:
    per 64-row tile, its present taps (any row's index >= 0) cut into
    ``clusters`` contiguous ascending shares, unless they fill one stage
    (64 / C taps); block j sums its share's bf16-rounded tap products in
    float32 in ascending tap order, and the blocks' sums are added in
    float32 in rank order. dout (B, M, C) bf16 values, idx (B, R, 27), wt
    (27, C, D) -> float32 (B, R, D)."""
    b, r, _ = idx.shape
    safe = np.clip(idx, 0, None)
    out = np.empty((b, r, wt.shape[-1]), np.float32)
    for item in range(b):
        g = dout[item][safe[item]].astype(np.float64) \
            * (idx[item] >= 0)[..., None]                   # (R, 27, C)
        taps = np.matmul(g.transpose(1, 0, 2), wt.astype(np.float64))
        taps = _round_f64(taps.transpose(1, 0, 2)).astype(np.float32)
        parts = np.zeros((clusters, r, wt.shape[-1]), np.float32)
        for t0 in range(0, r, 64):
            rows = slice(t0, t0 + 64)
            present = np.flatnonzero((idx[item, rows] >= 0).any(0))
            split = clusters if len(present) > 64 // wt.shape[1] else 1
            for j, share in enumerate(np.array_split(present, split)):
                for k in share:                           # ascending
                    parts[j, rows] += taps[rows, k]
        total = parts[0]
        for j in range(1, clusters):
            total = total + parts[j]
        out[item] = total
    return out


def test_kernel_c_cluster_sum_order_is_within_the_bound(sparse_scene):
    """Kernel C on the card splits a tile's taps over a cluster of 1, 2,
    4 or 8 blocks and adds their float32 sums in rank order: only the
    float32 association over the taps differs from one ascending sum.
    Emulated on the random layer, each such order stays within one bf16
    ulp of the largest tap product of JAX's bf16 VJP
    (utils/testing.py: dgrad_bf16_check), as the plain kernel C does."""
    from multimodal_gar_tpu_torch.utils.testing import (dgrad_bf16_check,
                                                        dgrad_tap_max)
    _, ref16, _, aux = _sparse_runs(sparse_scene, "random")
    maps = aux["maps"]
    dout = torch.from_numpy(aux["ct"]).bfloat16()
    wt = maps.dgrad_weights(torch.from_numpy(aux["kernel"]).bfloat16())
    tap_max = dgrad_tap_max(dout, maps.bwd, wt)
    ref = torch.from_numpy(np.asarray(ref16["d_features"], np.float32))
    orders = set()
    for clusters in (1, 2, 4, 8):
        got = torch.from_numpy(_kernel_c_cluster_sums(
            dout.float().numpy(), maps.bwd.numpy(), wt.float().numpy(),
            clusters))
        assert dgrad_bf16_check(got, ref, tap_max)["ok"], clusters
        orders.add(got.numpy().tobytes())
    assert len(orders) > 1          # the orders do differ in float32


# ---------------------------------------------------------------------------
# The plain kernel C and kernel D against their float64 definitions
# ---------------------------------------------------------------------------

def _round_f64(a: np.ndarray) -> np.ndarray:
    """An exact float64 sum as XLA's bf16 dot gives it: rounded to the
    float32 accumulator, then to bf16; held in float64."""
    return np.asarray(a.astype(np.float32).astype(BF).astype(np.float64))


def test_plain_kernel_c_is_its_definition(sparse_scene):
    """dF[r, c] = sum_k bf16(sum_d dout[idx[r, k], d] W[k, d, c]): each
    tap's exact product rounded at XLA's points, the taps summed exactly
    and rounded to float32 once; bit for bit."""
    idx = sparse_scene["random_idx"]
    rng = np.random.default_rng(9)
    dout = _bf16_values(rng.normal(size=(1, idx.shape[1], 64)))
    w = _bf16_values(rng.normal(size=(27, 64, 32)) / 8.0)
    safe = np.clip(idx, 0, None)
    g = dout[0][safe[0]].astype(np.float64) * (idx[0] >= 0)[..., None]
    taps = np.einsum("rkd,kdc->rkc", g, w.astype(np.float64))
    want = _round_f64(taps).sum(1).astype(np.float32)[None]
    got = subm_conv.subm_conv_dgrad_bf16(
        torch.from_numpy(dout).bfloat16(), torch.from_numpy(idx),
        torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_kernel_d_is_its_definition(sparse_scene):
    """dW[k] = bf16(sum_r table[idx[r, k]]^T dout[r]): the exact sum
    rounded at XLA's points once; bit for bit, a bf16 dW."""
    idx = sparse_scene["random_idx"]
    rng = np.random.default_rng(10)
    table = _bf16_values(rng.normal(size=(1, idx.shape[1], 32)))
    dout = _bf16_values(rng.normal(size=(1, idx.shape[1], 64)))
    safe = np.clip(idx, 0, None)
    g = table[0][safe[0]].astype(np.float64) * (idx[0] >= 0)[..., None]
    want = _round_f64(np.einsum("rkc,rd->kcd", g,
                                dout[0].astype(np.float64)))
    got = sparse_wgrad.sparse_wgrad_bf16(
        torch.from_numpy(table).bfloat16(), torch.from_numpy(idx),
        torch.from_numpy(dout).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.double().numpy(), want)


def test_first_layer_wgrad_at_bf16_is_padded_to_16(sparse_scene):
    """The input layer's 4 point features: K4 at bf16 runs the (16, D)
    instance on a table padded by zero columns and keeps dW's first 4
    rows, which are those of the unpadded sum."""
    idx = sparse_scene["random_idx"]
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.normal(size=(1, idx.shape[1], 4)).astype(
        np.float32)).bfloat16()
    dout = torch.from_numpy(rng.normal(size=(1, idx.shape[1], 16)).astype(
        np.float32)).bfloat16()
    got = sparse_wgrad.sparse_wgrad(table, torch.from_numpy(idx), dout)
    assert got.shape == (27, 4, 16) and got.dtype == torch.bfloat16
    want = sparse_wgrad.sparse_wgrad_plain(table, torch.from_numpy(idx),
                                           dout)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# BatchNorm, Dense, the I3D units and the non-local block in training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flax_dtype", [None, "bfloat16"])
def test_training_batchnorm_on_bf16_input_matches_jax(flax_dtype):
    """flax's masked BatchNorm in training on a bf16 input (the sparse
    conv's output): statistics in float32, the new running statistics,
    the output (float32 without a flax dtype, bf16 with one) and the VJP
    of input, scale and bias."""
    rng = np.random.default_rng(12)
    x = _bf16_values(rng.normal(1.0, 2.0, size=(2, 300, 32)))
    mask = rng.random((2, 300)) < 0.8
    ct = _bf16_values(rng.normal(size=x.shape))
    mask3 = jnp.broadcast_to(jnp.asarray(mask)[..., None], x.shape)
    refs, stats = [], []
    for dt in (BF, jnp.float32):
        mod = fnn.BatchNorm(use_running_average=False, epsilon=1e-3,
                            momentum=0.99,
                            dtype=BF if flax_dtype else None)
        v = random_variables(mod, jnp.asarray(x), seed=13, mask=mask3)

        def fn(x, scale, bias, mod=mod, v=v):
            out, upd = mod.apply({"params": {"scale": scale, "bias": bias},
                                  "batch_stats": v["batch_stats"]}, x,
                                 mask=mask3, mutable=["batch_stats"])
            return out, upd["batch_stats"]
        xin = jnp.asarray(x).astype(dt)
        (out, new), (dx, ds, db) = jax.jit(
            lambda x, s, b: _vjp_with_aux(fn, (x, s, b), ct))(
                xin, jnp.asarray(v["params"]["scale"]),
                jnp.asarray(v["params"]["bias"]))
        refs.append(dict(out=out, d_x=dx, d_scale=ds, d_bias=db))
        stats.append(new)
    bn = BatchNorm(32, 1e-3, device="cpu", momentum=0.99,
                   dtype=torch.bfloat16 if flax_dtype else torch.float32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    out = bn.train()(xt, torch.from_numpy(mask))
    assert out.dtype == (torch.bfloat16 if flax_dtype else torch.float32)
    assert str(out.dtype).endswith(str(refs[0]["out"].dtype))
    got = _port_grads(out, {"d_x": xt, "d_scale": bn.weight,
                            "d_bias": bn.bias}, ct)
    got["out"] = out
    assert got["d_x"].dtype == torch.bfloat16
    _check_all(got, refs[0], refs[1], f"BatchNorm dtype={flax_dtype}")
    for name, ref in (("mean", stats[0]["mean"]), ("var", stats[0]["var"])):
        check_bf16(getattr(bn, f"running_{name}"), ref, stats[1][name],
                   f"running {name}")


def _check_bias(got, ref16, ref32, drift, what: str) -> None:
    """A bf16 Dense's bias gradient. XLA on the CPU sums the bias's bf16
    cotangent over the rows with bf16 roundings, far from its float32 sum
    rounded once (test_xla_sums_a_bf16_bias_gradient_in_bf16), which the
    port gives, as ``jnp.sum`` of the same cotangent does. So bound 2 does
    not apply, and bound 1 (where JAX's own drift, None where not
    measured, stays below it) gives way where the port lies no farther
    from JAX's float32 gradient than JAX's bf16 one does."""
    got, ref16, ref32 = _f32(got), _f32(ref16), _f32(ref32)
    if drift is not None and _rel(_f32(drift), ref16) > TOL:
        return
    assert (_rel(got, ref16) <= TOL
            or _rel(got, ref32) <= _rel(ref16, ref32)), what


def _vjp_with_aux(fn, primals, ct):
    (out, aux), vjp = jax.vjp(lambda *p: fn(*p), *primals)
    zero_aux = jax.tree_util.tree_map(jnp.zeros_like, aux)
    return (out, aux), vjp((jnp.asarray(ct).astype(out.dtype), zero_aux))


def test_dense_vjp_matches_jax_bf16():
    """One flax Dense(dtype=bf16) and its VJP: d(x), d(kernel), d(bias)
    from autograd through the port's ``dense`` casts."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    ct = _bf16_values(rng.normal(size=(64, 80)))
    v = random_variables(fnn.Dense(80), jnp.asarray(x), seed=15)
    refs = []
    for dt in (BF, jnp.float32):
        mod = fnn.Dense(80, dtype=dt)
        out, (dx, dk, db) = _jax_vjp(
            lambda x, k, b, mod=mod: mod.apply(
                {"params": {"kernel": k, "bias": b}}, x),
            (jnp.asarray(x), jnp.asarray(v["params"]["kernel"]),
             jnp.asarray(v["params"]["bias"])), ct)
        refs.append(dict(out=out, d_x=dx, d_kernel=dk, d_bias=db))
    got = _port_dense(v, x, ct)
    assert got["d_x"].dtype == torch.float32
    _check_bias(got.pop("d_bias"), refs[0].pop("d_bias"),
                refs[1].pop("d_bias"), None, "Dense d_bias")
    _check_all(got, refs[0], refs[1], "Dense")


def _port_dense(v, x, ct) -> dict:
    lin = torch.nn.Linear(96, 80)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(v["params"]["kernel"].T.copy()))
        lin.bias.copy_(torch.from_numpy(v["params"]["bias"]))
    xt = torch.from_numpy(x).requires_grad_()
    out = dense(lin, xt, torch.bfloat16)
    got = _port_grads(out, {"d_x": xt, "d_kernel": lin.weight,
                            "d_bias": lin.bias}, ct)
    got["d_kernel"] = got["d_kernel"].T
    got["out"] = out
    return got


def test_xla_sums_a_bf16_bias_gradient_in_bf16():
    """Why a bf16 Dense's bias gradient is held to bound 1 only: JAX's VJP
    on the CPU lies farther from the exact sum of the bf16 cotangent,
    rounded once, than half its own bf16-vs-f32 gap, and so from the port,
    which gives that rounded sum bit for bit (as ``jnp.sum`` of the same
    cotangent does)."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    ct = _bf16_values(rng.normal(size=(64, 80)))
    v = random_variables(fnn.Dense(80), jnp.asarray(x), seed=15)
    db = {}
    for dt in (BF, jnp.float32):
        mod = fnn.Dense(80, dtype=dt)
        _, (_, _, db[dt]) = _jax_vjp(
            lambda x, k, b, mod=mod: mod.apply(
                {"params": {"kernel": k, "bias": b}}, x),
            (jnp.asarray(x), jnp.asarray(v["params"]["kernel"]),
             jnp.asarray(v["params"]["bias"])), ct)
    rounded = _bf16_values(ct.astype(np.float64).sum(0).astype(np.float32))
    np.testing.assert_array_equal(
        _f32(jnp.sum(jnp.asarray(ct).astype(BF), 0)), rounded)
    gap = _rel(_f32(db[BF]), _f32(db[jnp.float32]))
    assert _rel(rounded, _f32(db[BF])) > gap / 2
    np.testing.assert_array_equal(_f32(_port_dense(v, x, ct)["d_bias"]),
                                  rounded)


def _unit_train(jmod32, jmod16, port_cls, port_args, x, ct, ncdhw):
    """A flax Unit3D / NLBlockND in training (new statistics out) and its
    port, with the VJP of the input and of every parameter, the JAX
    side's in the port's layout: (port, JAX bf16, JAX f32, JAX bf16 on
    the input nudged). ``ncdhw``: the port module takes NCDHW (a body
    Unit3D) or gives it (both units)."""
    v = random_variables(jmod32, jnp.asarray(x), train=False, seed=16)
    flat = flatten_dict(v["params"])
    names = sorted(flat)
    refs = []
    for mod, xs in ((jmod16, x), (jmod32, x), (jmod16, _nudge(x, 19))):
        def fn(x, *leaves, mod=mod):
            params = {}
            for path, leaf in zip(names, leaves):
                node = params
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = leaf
            out, upd = mod.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, x,
                                 train=True, mutable=["batch_stats"])
            return out, upd["batch_stats"]
        xin = jnp.asarray(xs).astype(mod.dtype)
        (out, stats), grads = jax.jit(
            lambda x, *p, fn=fn: _vjp_with_aux(fn, (x,) + p, ct))(
                xin, *[jnp.asarray(flat[n]) for n in names])
        ref = {"out": out, "d_x": grads[0]}
        ref.update(dict(_target("params", n, np.asarray(g))
                        for n, g in zip(names, grads[1:])))
        ref.update(dict(_target("batch_stats", p, np.asarray(s))
                        for p, s in flatten_dict(stats).items()))
        refs.append(ref)
    mod = port_module(port_cls, *port_args, variables=v,
                      dtype=torch.bfloat16).train()
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    out = mod(xt.permute(0, 4, 1, 2, 3) if ncdhw == "in" else xt)
    if ncdhw:
        out = out.permute(0, 2, 3, 4, 1)
    params = dict(mod.named_parameters())
    tensors = {"d_x": xt}
    tensors.update({k: params[k] for k in refs[0] if k in params})
    got = _port_grads(out, tensors, ct)
    got["out"] = out
    state = mod.state_dict()
    got.update({k: state[k] for k in refs[0] if k in state
                and k not in params})
    return got, refs[0], refs[1], refs[2]


@pytest.mark.parametrize("unit", ["stem", "body"])
def test_training_unit3d_matches_jax_bf16(unit):
    """The trainable stem (XLA's bf16 s2d conv in JAX, ``F.conv3d`` at bf16
    in the port) and a body Unit3D, each with flax's BatchNorm(dtype=bf16)
    in training: output, VJP and new statistics."""
    rng = np.random.default_rng(17)
    if unit == "stem":
        x = _bf16_values(rng.normal(size=(1, 5, 24, 32, 3)))
        kw = dict(kernel=(7, 7, 7), stride=(2, 2, 2), s2d_stem=True)
        port = (StemUnit3D, (3, 64))
        ncdhw = "out"
        out_shape = (1, 3, 12, 16, 64)
        cout = 64
    else:
        x = _bf16_values(rng.normal(size=(1, 2, 6, 6, 64)))
        kw = dict(kernel=(3, 3, 3))
        port = (Unit3D, (64, 96, (3, 3, 3)))
        ncdhw = "in"
        out_shape = (1, 2, 6, 6, 96)
        cout = 96
    ct = _bf16_values(rng.normal(size=out_shape))
    got, ref16, ref32, drift = _unit_train(
        JaxUnit3D(cout, dtype=jnp.float32, **kw),
        JaxUnit3D(cout, dtype=BF, **kw), port[0], port[1], x, ct,
        ncdhw)
    assert got["out"].dtype == torch.bfloat16
    _check_all(got, ref16, ref32, f"{unit} Unit3D", drift)


def test_training_nonlocal_block_matches_jax_bf16():
    """The RGB branch's non-local block in training on bf16 patches, its
    BatchNorm's statistics over every row (no ``valid``): output, VJP and
    new statistics."""
    rng = np.random.default_rng(18)
    x = _bf16_values(rng.normal(size=(6, 5, 5, 64)))
    ct = _bf16_values(rng.normal(size=x.shape))
    got, ref16, ref32, drift = _unit_train(
        JaxNL(64, 8, "dot"), JaxNL(64, 8, "dot", dtype=BF), NLBlockND,
        (64, 8), x, ct, None)
    assert got["out"].dtype == torch.bfloat16
    # W_z's bias feeds a BatchNorm with batch statistics: its gradient is
    # zero in exact arithmetic, rounding noise on both sides, each held
    # within bound 1 of the layer's weight gradient
    scale = np.abs(_f32(ref16["W_z.weight"])).max()
    for side in (got, ref16, ref32, drift):
        assert np.abs(_f32(side.pop("W_z.bias"))).max() <= TOL * scale
    for key in ("g.bias", "theta.bias", "phi.bias"):
        _check_bias(got.pop(key), ref16.pop(key), ref32.pop(key),
                    drift.pop(key), f"NLBlockND {key}")
    _check_all(got, ref16, ref32, "NLBlockND", drift)


# ---------------------------------------------------------------------------
# The whole MGAR train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_runs():
    """JAX's MGAR train step (losses, new statistics, gradients) at
    tiny_config in bf16, in float32 and in bf16 on nudged inputs, with the
    grad-parity batch of tests/test_torch_train_step.py and dropout off;
    and the port's bf16 training forward and backward."""
    cfg = exact_pool_config(tiny_config())
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="bfloat16"))
    fields = condition_for_grad_parity_(
        synthetic_batch_numpy(cfg, batch_size=2, seed=0))
    variables = random_variables(JaxMGAR(cfg), jax_batch(fields),
                                 train=False, seed=0)
    d_embed = variables["params"]["gar_fusion"]["D_embed"]
    d_embed["kernel"] = np.array([[1.0], [4.0]], np.float32)
    d_embed["bias"] = np.array([0.3], np.float32)
    w_z = variables["params"]["rgb_backbone"]["self_att"]["W_z"]
    w_z["bias"] = np.zeros_like(w_z["bias"])
    jv = to_jax(variables)

    def step_of(c):
        jmodel = JaxMGAR(c)

        def loss_fn(params, batch_stats, jb):
            out, upd = jmodel.apply(
                {"params": params, "batch_stats": batch_stats}, jb,
                train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            losses = jax_losses.compute_losses(out, jb)
            return (jax_losses.total_loss(losses, "L_total"),
                    (losses, upd["batch_stats"]))
        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    nudged = dict(fields, images=_nudge(fields["images"], 1),
                  voxels=_nudge(fields["voxels"], 2))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        step16 = step_of(cfg16)
        for name, step, f in (("ref16", step16, fields),
                              ("drift", step16, nudged),
                              ("ref32", step_of(cfg), fields)):
            (loss, (losses, stats)), grads = step(
                jv["params"], jv["batch_stats"], jax_batch(f))
            runs[name] = dict(
                losses=dict(losses, L_total=loss),
                stats=dict(_target("batch_stats", p, np.asarray(v))
                           for p, v in flatten_dict(stats).items()),
                grads=dict(_target("params", p, np.asarray(g))
                           for p, g in flatten_dict(grads).items()))
    model = prepare_grad_parity_(port_module(MGAR, cfg16,
                                             variables=variables)).train()
    batch = batch_from_numpy(fields)
    losses = compute_losses(model(batch), batch)
    loss = total_loss(losses, "L_total")
    params = dict(model.named_parameters())
    trainable = [k for k, p in params.items() if p.requires_grad]
    grads = torch.autograd.grad(loss, [params[k] for k in trainable],
                                allow_unused=True)
    runs["got"] = dict(
        losses=dict({k: v.detach() for k, v in losses.items()},
                    L_total=loss.detach()),
        stats={k: v for k, v in model.state_dict().items()
               if k in runs["ref16"]["stats"]},
        grads={k: torch.zeros_like(params[k]) if g is None else g
               for k, g in zip(trainable, grads)})
    return runs


def test_mgar_train_losses_match_jax_bf16(train_runs):
    """L_total and each term under both bounds, as the gradient leaves
    are: bound 2 where JAX's own drift stays below half its gap (the rule
    of tests/test_torch_bf16.py for a whole model), bound 1 where that
    drift stays below bound 1 (L_mse's, ~5e-2, does not); the readings
    with ``pytest -s``."""
    r = train_runs
    for name, ref in r["ref16"]["losses"].items():
        drift = _rel(r["drift"]["losses"][name], ref)
        print(f"{name}: JAX gap {_rel(ref, r['ref32']['losses'][name]):.3g}"
              f", JAX drift {drift:.3g}, port "
              f"{_rel(_f32(r['got']['losses'][name]), ref):.3g}")
        if drift > TOL:
            continue
        check_bf16(r["got"]["losses"][name], ref,
                   r["ref32"]["losses"][name], name, drift)
    assert _rel(_f32(r["got"]["losses"]["L_total"]),
                r["ref16"]["losses"]["L_total"]) <= TOL


def test_mgar_train_batch_stats_match_jax_bf16(train_runs):
    r = train_runs
    stats = r["got"]["stats"]
    assert set(stats) == set(r["ref16"]["stats"])
    for key, ref in r["ref16"]["stats"].items():
        assert _rel(_f32(stats[key]), ref) <= TOL, key


def test_mgar_train_gradients_match_jax_bf16(train_runs):
    """Every gradient finite, each sparse layer's weight gradient
    non-zero and no farther from JAX bf16 than JAX's own drift, and each
    leaf within bound 1 of JAX bf16 wherever JAX's own drift stays below
    it; the frozen I3D has no gradient on either side."""
    r = train_runs
    got, ref16 = r["got"]["grads"], r["ref16"]["grads"]
    drifting = []
    for key, ref in ref16.items():
        if key.startswith("rgb_backbone.i3d."):
            assert key not in got and not np.any(ref), key
            continue
        g = _f32(got[key])
        assert np.all(np.isfinite(g)), key
        drift = _rel(r["drift"]["grads"][key], ref)
        gap = _rel(ref, r["ref32"]["grads"][key])
        if drift > TOL:
            drifting.append((key, drift, gap))
            continue
        assert _rel(g, ref) <= TOL, (key, _rel(g, ref), drift)
    assert set(got) == {k for k in ref16
                        if not k.startswith("rgb_backbone.i3d.")}
    for name, *_ in SPARSE_LAYERS:
        key = f"lidar_backbone.backbone3d.{name}.conv.weight"
        assert torch.count_nonzero(got[key]) > 0, name
        # where kernels C and D sit: nearer JAX's bf16 gradient than JAX's
        # own run on the nudged inputs lies (each past bound 1 in that
        # drift, so not held above)
        assert _rel(_f32(got[key]), ref16[key]) \
            <= _rel(r["drift"]["grads"][key], ref16[key]), key
    for key, drift, gap in drifting:        # the readings, with pytest -s
        print(f"{key}: JAX drift {drift:.3g}, JAX gap {gap:.3g}, port "
              f"{_rel(_f32(got[key]), ref16[key]):.3g}")
