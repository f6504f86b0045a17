"""The sparse modules that take a ``dtype`` in the JAX package, at bf16
against it: UNetV2, VoxelResBackbone8x, PillarRes18Backbone and
FocalSparseConv, each module's eval forward and its VJP (through the
features and every parameter, BatchNorms on their running statistics)
against ``jax.vjp`` at bf16. And the coverage of the bf16 kernels: every
sparse layer of these modules, of VoxelBackbone8x and of the two
detectors built on them (PartA2, VoxelNeXt) at their default widths, walked
and held against the pair sets of the forward core, kernel C and kernel D.

Same numpy-seeded inputs, weights (through the converter) and cotangents on
both sides; the JAX side on the CPU, as its own tests run it. Bound 2's
float32 side is the port's own float32 module on the same weights and
inputs, which tests/test_torch_det_next.py and test_torch_det_extras.py
hold to JAX's to 1e-4 of the largest value, a tenth of the smallest gap
bound 2 reads (1e-3): it spares a second JAX trace of each module. The two
bounds of tests/test_torch_bf16.py, with the rules of
tests/test_torch_bf16_train.py's whole step: a module of 12 to 40 sparse
layers carries one-ulp flips of its bf16 sums through every later layer,
and JAX's own bf16 run on inputs moved by one ulp at 0.1% of their values
drifts as far on some outputs and gradients. So each output is held to
bound 1 and, where that drift stays below half JAX's own bf16-vs-f32 gap,
to bound 2 (half the gap), as the step's losses are; each gradient leaf
to bound 1 wherever the drift stays below it, as the step's gradients are
(bound 2 is held layer by layer there: a UNetV2 weight gradient at the end
of 30 layers' backward lands a little past half the gap). The leaves the
drift leaves out are printed (``pytest -s``); most leaves of each module
are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models.sparse_backbone import SparseTensor as JaxST
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
from multimodal_gar_tpu_torch.utils.testing import sparse_input_numpy
from tests.test_torch_bf16 import BF, TOL, _f32, _nudge, _rel, check_bf16
from tests.test_torch_common import random_variables, to_jax
from tests.test_torch_det_common import expected_tensors

CPU = dict(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _outputs(name, out) -> dict:
    """The module's float outputs by name, JAX's or the port's."""
    if name == "UNetV2":
        up, ms = out
        return {"x_up1": up.features, "x_conv4": ms["x_conv4"].features}
    if name == "FocalSparseConv":
        new, imp = out
        return {"features": new.features, "importance": imp}
    return {k: st.features for k, st in out.items()}


def _case(name):
    """(JAX module at a dtype, port module at a dtype, numpy inputs) of
    one module at the widths of its float32 parity test."""
    import multimodal_gar_tpu.detection.extras as jx
    import multimodal_gar_tpu.detection.sparse_backbones as jsb
    import multimodal_gar_tpu_torch.detection.extras as px
    import multimodal_gar_tpu_torch.detection.sparse_backbones as psb
    kw = dict(generator=torch.Generator().manual_seed(0), **CPU)
    if name in ("UNetV2", "VoxelResBackbone8x"):
        caps = (40, 16, 8, 4)
        inputs = sparse_input_numpy(m=40, c=4, shape=(9, 16, 16))
        return (lambda dt: getattr(jsb, name)(max_voxels_per_stage=caps,
                                              dtype=dt),
                lambda dt: getattr(psb, name)(4, max_voxels_per_stage=caps,
                                              dtype=dt, **kw), inputs)
    if name == "PillarRes18Backbone":
        ch, caps = (8, 16, 16, 32), (60, 30, 12, 4)
        return (lambda dt: jx.PillarRes18Backbone(
                    channels=ch, max_voxels_per_stage=caps, dtype=dt),
                lambda dt: px.PillarRes18Backbone(8, ch, caps, dtype=dt,
                                                  **kw),
                sparse_input_numpy())
    f, c, v, shape = sparse_input_numpy(seed=2, m=48, c=8, shape=(5, 8, 8))
    v[1, 20:], c[1, 20:], f[1, 20:] = False, -1, 0.0
    return (lambda dt: jx.FocalSparseConv(out_channels=16, top_k=36,
                                          dtype=dt),
            lambda dt: px.FocalSparseConv(8, 16, 36, dtype=dt, **kw),
            (f, c, v, shape))


@pytest.fixture(scope="module", params=["UNetV2", "VoxelResBackbone8x",
                                        "PillarRes18Backbone",
                                        "FocalSparseConv"])
def module_runs(request):
    """JAX's eval forward and VJP at bf16, at float32 and at bf16 on the
    nudged features; the port's at bf16."""
    name = request.param
    jmod, pmod, (f, c, v, shape) = _case(name)
    jst = JaxST(jnp.asarray(f), jnp.asarray(c), jnp.asarray(v), shape)
    variables = random_variables(jmod(jnp.float32), jst, train=False, seed=1)
    jv = to_jax(variables)
    port32 = pmod(torch.float32)
    model = load_jax_variables(pmod(torch.bfloat16), variables).eval()
    x = _t(f).requires_grad_()
    out = _outputs(name, model(SparseTensor(x, _t(c), _t(v), shape)))
    rng = np.random.default_rng(5)
    cts = {k: np.asarray(jnp.asarray(rng.normal(size=o.shape), BF)
                         .astype(jnp.float32)) for k, o in out.items()}
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(
        list(out.values()), [x] + list(params.values()),
        [_t(cts[k]).to(o.dtype) for k, o in out.items()])
    got = {**{f"out {k}": o.detach() for k, o in out.items()},
           "d features": grads[0],
           **{f"d {k}": g for k, g in zip(params, grads[1:])}}

    def fn(mod, p, x):
        return _outputs(name, mod.apply(
            {"params": p, "batch_stats": jv.get("batch_stats", {})},
            jst.replace(features=x), train=False))

    def vjp(p, x, cts):
        out, back = jax.vjp(lambda p, x: fn(jmod(BF), p, x), p, x)
        return out, back({k: ct.astype(out[k].dtype)
                          for k, ct in cts.items()})
    step16 = jax.jit(vjp)
    refs = {}
    for key, feats in (("ref16", f), ("drift", _nudge(f, 2))):
        out16, (dparams, dx) = step16(jv["params"], jnp.asarray(feats),
                                      {k: jnp.asarray(a)
                                       for k, a in cts.items()})
        want = expected_tensors(port32, jax.device_get(dparams),
                                variables.get("batch_stats", {}))
        refs[key] = {**{f"out {k}": o for k, o in out16.items()},
                     "d features": dx,
                     **{f"d {k}": want[k] for k in params}}
    # float32, the port's: the outputs only (bound 2 reads its gap on
    # the outputs)
    model32 = load_jax_variables(port32, variables).eval()
    with torch.no_grad():
        out32 = _outputs(name, model32(SparseTensor(_t(f), _t(c), _t(v),
                                                    shape)))
    refs["ref32"] = {f"out {k}": o for k, o in out32.items()}
    return name, got, refs


def test_module_forward_and_vjp_match_jax_bf16(module_runs):
    """Outputs in JAX's dtypes (bf16 where the module ends on a sparse
    conv, float32 after a BatchNorm), every gradient float32, and each
    output and gradient leaf under the two bounds where JAX's own drift
    allows."""
    name, got, refs = module_runs
    ref16, ref32, drift = refs["ref16"], refs["ref32"], refs["drift"]
    assert set(got) == set(ref16)
    held, drifting = 0, []
    for key, ref in ref16.items():
        want = torch.bfloat16 if ref.dtype == BF else torch.float32
        assert got[key].dtype == want, (key, got[key].dtype, ref.dtype)
        assert np.all(np.isfinite(_f32(got[key]))), key
        d = _rel(_f32(drift[key]), _f32(ref))
        if d > TOL:
            drifting.append(key)
            continue
        if key.startswith("out"):
            check_bf16(got[key], ref, ref32[key], f"{name} {key}", d)
        else:
            err = _rel(_f32(got[key]), _f32(ref))
            assert err <= TOL, (f"{name} {key}", err, d)
        held += 1
    print(f"{name}: {held} of {len(ref16)} leaves held, past bound 1 in "
          f"JAX's own drift: {drifting}")
    assert held >= 0.75 * len(ref16), drifting
    assert not any(k.startswith("out") for k in drifting) \
        or name == "FocalSparseConv", drifting


# ---------------------------------------------------------------------------
# Coverage: every sparse layer's pair in the bf16 kernels' sets
# ---------------------------------------------------------------------------

def _sparse_layers(model: torch.nn.Module):
    """(name, cin, cout, takes a data gradient, weight padded to 16
    columns) of each 3x3x3 sparse conv of ``model``, in module order: a
    conv on the voxel features (a backbone's conv_input) takes no data
    gradient; FocalSparseConv's importance conv is padded to D = 16."""
    from multimodal_gar_tpu_torch.detection.extras import (
        FocalSparseConv, PillarRes18Backbone)
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseConv
    trainable_input = {id(m.conv_input.conv) for m in model.modules()
                       if isinstance(m, PillarRes18Backbone)}
    importance = {id(m.importance) for m in model.modules()
                  if isinstance(m, FocalSparseConv)}
    for name, m in model.named_modules():
        if not isinstance(m, SparseConv):
            continue
        _, cin, cout = m.weight.shape
        first = name.endswith("conv_input.conv") \
            and id(m) not in trainable_input
        yield name, cin, cout, not first, id(m) in importance


def _default_modules():
    import multimodal_gar_tpu_torch.detection.extras as px
    import multimodal_gar_tpu_torch.detection.sparse_backbones as psb
    from multimodal_gar_tpu_torch.detection import build_detector
    from multimodal_gar_tpu_torch.detection.detectors import DetectorConfig
    from multimodal_gar_tpu_torch.models.sparse_backbone import (
        VoxelBackbone8x)
    kw = dict(generator=torch.Generator().manual_seed(0), device="cpu",
              dtype=torch.bfloat16)
    mods = {"VoxelBackbone8x": VoxelBackbone8x(4, **kw),
            "VoxelResBackbone8x": psb.VoxelResBackbone8x(4, **kw),
            "UNetV2": psb.UNetV2(4, **kw),
            "PillarRes18Backbone": px.PillarRes18Backbone(64, **kw)}
    for cin in (16, 32, 64):
        mods[f"FocalSparseConv {cin}"] = px.FocalSparseConv(cin, cin, 100,
                                                            **kw)
    for name in ("PartA2", "VoxelNeXt"):
        mods[name] = build_detector(
            name, DetectorConfig(name=name, dtype="bfloat16"), device="cpu")
    return mods


def test_bf16_kernel_sets_cover_every_sparse_layer():
    """Each layer's forward pair (its input zero-padded to 16, the
    importance conv's one column to 16) in the forward core's set, its
    transposed pair in kernel C's where its input takes a data gradient,
    and its pair in kernel D's: no bf16 layer of these modules raises on
    the card for want of an instance."""
    from multimodal_gar_tpu_torch.ops.kernels import sparse_wgrad, subm_conv
    from multimodal_gar_tpu_torch.ops.kernels._pad import (kernel_width,
                                                           wgrad_width)
    bf = torch.bfloat16
    reached = {"forward": set(), "kernel C": set(), "kernel D": set()}
    for mod_name, mod in _default_modules().items():
        layers = list(_sparse_layers(mod))
        assert layers, mod_name
        for name, cin, cout, dgrad, padded in layers:
            d = 16 if padded else cout
            assert not padded or cout == 1, name
            fwd = (kernel_width(cin, bf), d)
            reached["forward"].add(fwd)
            assert fwd in subm_conv.SUPPORTED_BF16, (mod_name, name, fwd)
            if dgrad:
                reached["kernel C"].add((d, cin))
                assert (d, cin) in subm_conv.SUPPORTED_DGRAD_BF16, (
                    mod_name, name, (d, cin))
            wgrad = (wgrad_width(cin, bf), d)
            reached["kernel D"].add(wgrad)
            assert wgrad in sparse_wgrad.SUPPORTED_BF16, (mod_name, name,
                                                          wgrad)
    # the sets hold no pair that no layer reaches
    assert reached["forward"] == subm_conv.SUPPORTED_BF16
    assert reached["kernel C"] == subm_conv.SUPPORTED_DGRAD_BF16
    assert reached["kernel D"] == sparse_wgrad.SUPPORTED_BF16
