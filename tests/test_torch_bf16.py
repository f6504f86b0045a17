"""The port at ``model.dtype: bfloat16`` against the JAX package at bf16.

Same numpy-seeded inputs and weights on both sides (weights through the
converter; parameters stay float32 and every module casts at the point of
use, as flax does). The JAX side runs on the CPU as its own tests run it:
its Pallas kernels are gated off at bf16 anyway (XLA's conv for the stem,
the gather + einsum for the sparse convs). XLA on the CPU computes a bf16
dot or conv as a float32 sum rounded once to bf16, and rounds an
elementwise bf16 op, Python numbers rounded to bf16 first; the port does
the same (test_xla_rounds_a_bf16_dense_as_the_port_does checks the first
on one layer).

Tolerance, for each output:
  1. within 2e-2 of its largest JAX bf16 value;
  2. where JAX's own bf16-vs-f32 gap on the same inputs (max |bf16 - f32|
     over the largest |f32|) is at least 1e-3, within half that gap. This
     is what shows the casts sit where JAX's do: a port that computed in
     float32 where JAX rounds would be a whole gap away. Checked for the
     modules that hold a kernel (the stem unit, an x-window, a nbr-map and
     a strided sparse layer) and the bf16 layers around them (a body
     Unit3D, RoIAlign, the non-local block on bf16 and on float32 input).
     Through a whole model the bound holds where it can hold: two bf16
     runs that sum in other orders round differently at ~1e-4 of a
     layer's outputs, and over the I3D's 20 layers those one-ulp flips
     spread like the rounding itself. JAX against itself shows it: moved
     by one bf16 ulp at 0.1% of its input values, its own bf16 outputs
     drift by more than half the gap on several outputs
     (test_jax_bf16_drifts_past_half_the_gap_by_itself). So the whole MGAR
     and the detectors hold bound 2 on every output where that drift stays
     below half the gap, and bound 1 everywhere.
The plain kernel versions at bf16 are their float32 versions on the
upcast inputs, rounded: equal bit for bit.
"""
import copy
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.detection import build_detector as jax_build
from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu.models.i3d import Unit3D as JaxUnit3D
from multimodal_gar_tpu.models.nonlocal_block import NLBlockND as JaxNL
from multimodal_gar_tpu.models.sparse_backbone import (
    SparseConvBlock as JaxBlock, SparseTensor as JaxSparseTensor)
from multimodal_gar_tpu.ops.roi_align import roi_align as jax_roi_align
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.detection import build_detector
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.models.i3d import StemUnit3D, Unit3D
from multimodal_gar_tpu_torch.models.nonlocal_block import NLBlockND
from multimodal_gar_tpu_torch.models.sparse_backbone import SparseConvBlock
from multimodal_gar_tpu_torch.ops.kernels import (sparse_wgrad, stem_conv,
                                                  subm_conv, window_conv)
from multimodal_gar_tpu_torch.ops.roi_align import roi_align
from multimodal_gar_tpu_torch.ops.sparse_maps import ConvMaps
from multimodal_gar_tpu_torch.train.train_state import (make_eval_step,
                                                        make_optimizer,
                                                        make_train_step)
from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                    stem_inputs_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_detection import det_batch, tiny_voxel_cfg
from tests.test_torch_common import (exact_pool_config, jax_batch,
                                     port_module, random_variables, to_jax)
from tests.test_torch_det_common import port_batch, port_cfg, with_rulebook

BF = jnp.bfloat16
TOL = 2e-2            # bound 1, of the largest JAX bf16 value
GAP_MIN = 1e-3        # bound 2 applies where JAX's own gap is this or more
NUDGE_SHARE = 1e-3    # share of input values moved by one ulp (the drift)


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - ref), initial=0.0)
                 / max(float(np.max(np.abs(ref), initial=0.0)), 1e-30))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def check_bf16(got, ref16, ref32, what: str, drift=None) -> None:
    """Bounds 1 and 2 (module docstring) of one output; ``drift``, where
    given, is JAX's own drift on nudged inputs, and bound 2 then applies
    only where it is below half the gap."""
    got, ref16, ref32 = _f32(got), _f32(ref16), _f32(ref32)
    err = _rel(got, ref16)
    assert err <= TOL, f"{what}: {err:.3g} of the largest value > {TOL}"
    gap = _rel(ref16, ref32)
    if gap < GAP_MIN or (drift is not None and drift > gap / 2):
        return
    assert err <= gap / 2, (f"{what}: {err:.3g} from JAX bf16, more than "
                            f"half JAX's own bf16-vs-f32 gap {gap:.3g}")


def _nudge(a: np.ndarray, seed: int) -> np.ndarray:
    """``a`` rounded to bf16, with NUDGE_SHARE of its values moved up by
    one bf16 ulp; float32."""
    bits = np.asarray(jnp.asarray(a, jnp.float32).astype(BF)).view(
        np.uint16).copy()
    bits[np.random.default_rng(seed).random(a.shape) < NUDGE_SHARE] += 1
    return np.asarray(jnp.asarray(bits.view(BF)).astype(jnp.float32))


# ---------------------------------------------------------------------------
# XLA's rounding and the plain kernel versions
# ---------------------------------------------------------------------------

def test_xla_rounds_a_bf16_dense_as_the_port_does():
    """One flax Dense at bf16 on the CPU: the float32 product of the
    bf16-rounded inputs, rounded once, then the bf16 bias in bf16 (a second
    rounding): the port's ``dense`` gives the same bits."""
    import flax.linen as fnn
    from multimodal_gar_tpu_torch.models.layers import dense
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    jmod = fnn.Dense(80, dtype=BF)
    v = random_variables(jmod, jnp.asarray(x), seed=1)
    ref = jax.jit(jmod.apply)(to_jax(v), jnp.asarray(x))
    lin = torch.nn.Linear(96, 80)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(v["params"]["kernel"].T.copy()))
        lin.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        got = dense(lin, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(ref))


def test_stem_plain_bf16_is_the_f32_sum_rounded_then_biased():
    xd, w2, _, bias = stem_inputs_numpy((1, 5, 9, 20, 12), seed=3)
    xd, w2, bias = (torch.from_numpy(a).bfloat16() for a in (xd, w2, bias))
    got = stem_conv.stem_conv_plain(xd, w2, None, bias, (3, 3))
    y = stem_conv.stem_conv_sum(xd.float(), w2.float(), (3, 3))
    want = torch.relu(y.to(torch.bfloat16) + bias.view(1, -1, 1, 1, 1))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(stem_conv.stem_conv_bf16(xd, w2, bias, (3, 3)), got)


@pytest.mark.parametrize("kind", ["window", "subm"])
def test_sparse_plain_bf16_is_the_f32_version_rounded(kind):
    cfg = tiny_config()
    rb = synthetic_batch_numpy(cfg, batch_size=2, seed=0)["rulebook"]
    rng = np.random.default_rng(4)
    maps = torch.from_numpy(rb["win_1"] if kind == "window"
                            else rb["nbr_1"])
    m = maps.shape[1]
    feats = torch.from_numpy(rng.normal(size=(2, m, 32)).astype(np.float32)
                             ).bfloat16()
    w = torch.from_numpy(rng.normal(size=(27, 32, 64)).astype(np.float32)
                         ).bfloat16()
    mod = window_conv if kind == "window" else subm_conv
    plain = (mod.window_conv_plain if kind == "window"
             else mod.subm_conv_plain)
    got = plain(feats, maps, w)
    want = plain(feats.float(), maps, w.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    wrapper = (window_conv.window_conv_bf16 if kind == "window"
               else subm_conv.subm_conv_bf16)
    assert torch.equal(wrapper(feats, maps, w), got)


# ---------------------------------------------------------------------------
# The modules that hold a kernel, and the bf16 layers around them
# ---------------------------------------------------------------------------

def _unit_pair(jmod, port_cls, port_args, x_jax, x_port, seed):
    v = random_variables(jmod.clone(dtype=jnp.float32), x_jax, train=False,
                         seed=seed)
    run = jax.jit(lambda v, a, m: m.apply(v, a, train=False),
                  static_argnums=2)
    ref16 = run(to_jax(v), x_jax.astype(BF), jmod)
    ref32 = run(to_jax(v), x_jax.astype(BF).astype(jnp.float32),
                jmod.clone(dtype=jnp.float32))
    mod = port_module(port_cls, *port_args, variables=v,
                      dtype=torch.bfloat16)
    with torch.no_grad():
        got = mod(x_port.bfloat16())
    return got, ref16, ref32


def test_stem_unit_matches_jax_bf16():
    """Conv3d_1a_7x7 at bf16: the folded kernel rounded, XLA's conv, the
    bias in bf16, ReLU (models/i3d.py:281-311) against StemUnit3D and the
    bf16 stem kernel's plain version."""
    x = np.random.default_rng(0).normal(size=(1, 5, 24, 32, 3)).astype(
        np.float32)
    jmod = JaxUnit3D(64, (7, 7, 7), (2, 2, 2), s2d_stem=True, dtype=BF)
    got, ref16, ref32 = _unit_pair(jmod, StemUnit3D, (3, 64),
                                   jnp.asarray(x), torch.from_numpy(x), 1)
    assert got.dtype == torch.bfloat16
    check_bf16(got.permute(0, 2, 3, 4, 1), ref16, ref32, "stem unit")


def test_body_unit_matches_jax_bf16():
    x = np.random.default_rng(1).normal(size=(1, 2, 6, 6, 64)).astype(
        np.float32)
    jmod = JaxUnit3D(96, (3, 3, 3), dtype=BF)
    got, ref16, ref32 = _unit_pair(
        jmod, Unit3D, (64, 96, (3, 3, 3)), jnp.asarray(x),
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), 2)
    check_bf16(got.permute(0, 2, 3, 4, 1), ref16, ref32, "Unit3D 3x3x3")


def test_roi_align_matches_jax_bf16():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 16, 3, 4)).astype(np.float32)
    xy = rng.uniform(0, [44, 28], size=(2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, size=(2, 6, 2))],
                           -1).astype(np.float32)
    got = roi_align(torch.from_numpy(feats).bfloat16(),
                    torch.from_numpy(boxes), out_size=5,
                    spatial_scale=4 / 64)
    for b in range(2):
        f = jnp.asarray(feats[b]).astype(BF)
        ref16 = jax_roi_align(f, jnp.asarray(boxes[b]), out_size=5,
                              spatial_scale=4 / 64)
        ref32 = jax_roi_align(f.astype(jnp.float32), jnp.asarray(boxes[b]),
                              out_size=5, spatial_scale=4 / 64)
        check_bf16(got[b], ref16, ref32, f"roi_align item {b}")


@pytest.mark.parametrize("shape,input_dtype", [
    ((6, 5, 5, 64), "bfloat16"),        # the RGB branch: bf16 patches
    ((4, 2, 2, 2, 96), "float32")])     # the LiDAR branch: f32 grid pool
def test_nonlocal_block_matches_jax_bf16(shape, input_dtype):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    c = shape[-1]
    xj = jnp.asarray(x).astype(jnp.dtype(input_dtype))
    v = random_variables(JaxNL(c, c // 8, "dot"), jnp.asarray(x),
                         train=False, seed=5)
    ref16 = JaxNL(c, c // 8, "dot", dtype=BF).apply(to_jax(v), xj,
                                                    train=False)
    ref32 = JaxNL(c, c // 8, "dot").apply(to_jax(v),
                                          xj.astype(jnp.float32),
                                          train=False)
    mod = port_module(NLBlockND, c, c // 8, variables=v,
                      dtype=torch.bfloat16)
    with torch.no_grad():
        got = mod(torch.from_numpy(_f32(xj).copy()).to(
            getattr(torch, input_dtype)))
    # bf16 + bf16 residual stays bf16; bf16 + f32 promotes, as in JAX
    assert str(got.dtype).endswith(str(ref16.dtype))
    check_bf16(got, ref16, ref32, f"NLBlockND {shape}")


@pytest.fixture(scope="module")
def sparse_scene():
    """Stage-0/1 maps of the tiny batch's rulebook and a float32 table of
    16 channels (a BatchNorm's output: the layer rounds it)."""
    cfg = tiny_config()
    f = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    rb = f["rulebook"]
    m0 = rb["win_0"].shape[1]
    feats = np.random.default_rng(6).normal(size=(2, m0, 16)).astype(
        np.float32)
    count = rb["count_1"]
    m1 = rb["coords_1"].shape[1]
    valid1 = np.arange(m1)[None, :] < count[:, None]
    valid0 = np.arange(m0)[None, :] < f["voxel_valid"].sum(1)[:, None]
    return dict(rb=rb, feats=feats, valid0=valid0, valid1=valid1)


@pytest.mark.parametrize("layer", ["x_window", "nbr_map", "strided"])
def test_sparse_layer_matches_jax_bf16(sparse_scene, layer):
    """One SparseConvBlock at bf16 (conv -> BN -> ReLU): the x-window
    submanifold layer over win_0, the nbr-map one over nbr_0, the strided
    one over dwin_1 (models/sparse_backbone.py:141-177, :268-300)."""
    s = sparse_scene
    rb = s["rb"]
    cout = 32 if layer == "strided" else 16
    jst = JaxSparseTensor(features=jnp.asarray(s["feats"]),
                          coords=jnp.zeros(s["feats"].shape[:2] + (3,),
                                           jnp.int32),
                          valid=jnp.asarray(s["valid0"]),
                          spatial_shape=(8, 32, 32))
    if layer == "strided":
        out_valid = s["valid1"]
        kw = dict(window_pre=(jnp.asarray(rb["coords_1"]),
                              jnp.asarray(out_valid),
                              jnp.asarray(rb["dwin_1"])))
        args = dict(conv_type="spconv", stride=2, padding=1)
    else:
        out_valid = s["valid0"]
        kw = (dict(window=jnp.asarray(rb["win_0"])) if layer == "x_window"
              else dict(neighbor_idx=jnp.asarray(rb["nbr_0"])))
        args = dict(conv_type="subm")
    j32 = JaxBlock(cout, dtype=jnp.float32, **args)
    j16 = JaxBlock(cout, dtype=BF, **args)
    v = random_variables(j32, jst, train=False, seed=7, **kw)
    ref32 = jax.jit(lambda v: j32.apply(v, jst, train=False, **kw))(
        to_jax(v)).features
    ref16 = jax.jit(lambda v: j16.apply(v, jst, train=False, **kw))(
        to_jax(v)).features
    mod = port_module(SparseConvBlock, 16, cout, variables=v,
                      dtype=torch.bfloat16)
    feats = torch.from_numpy(s["feats"])
    valid = torch.from_numpy(out_valid)
    win = maps = None
    if layer == "x_window":
        win = torch.from_numpy(rb["win_0"])
    elif layer == "strided":
        win = torch.from_numpy(rb["dwin_1"])
    else:
        nbr = torch.from_numpy(rb["nbr_0"])
        maps = ConvMaps(nbr, None, True)
    launches = (window_conv.window_conv.launches,
                window_conv.window_conv_bf16.launches)
    with torch.no_grad():
        got = mod(feats, win, maps, valid)
    # the CPU runs the plain versions, never a kernel
    assert (window_conv.window_conv.launches,
            window_conv.window_conv_bf16.launches) == launches
    assert got.dtype == torch.float32 and ref16.dtype == jnp.float32
    check_bf16(got, ref16, ref32, f"{layer} layer")


# ---------------------------------------------------------------------------
# The whole MGAR eval forward and the tiny detectors
# ---------------------------------------------------------------------------

FLOAT_FIELDS = ("a_theta", "card", "rgb_features", "lidar_features",
                "fused_features")
TUPLE_FIELDS = ("pose", "interaction", "sg_pose", "sg_interaction")


def _outputs(out) -> dict:
    got = {name: getattr(out, name) for name in FLOAT_FIELDS}
    for name in TUPLE_FIELDS:
        for i, t in enumerate(getattr(out, name)):
            got[f"{name}[{i}]"] = t
    return got


@pytest.fixture(scope="module")
def mgar_runs():
    """JAX's MGAR at tiny_config in float32 and bfloat16, its bf16 run on
    nudged inputs, and the port's bf16 eval forward."""
    cfg = exact_pool_config(tiny_config())
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="bfloat16"))
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    variables = random_variables(JaxMGAR(cfg), jax_batch(fields),
                                 train=False, seed=0)
    j16 = jax.jit(partial(JaxMGAR(cfg16).apply, train=False))
    ref32 = jax.jit(partial(JaxMGAR(cfg).apply, train=False))(
        to_jax(variables), jax_batch(fields))
    ref16 = j16(to_jax(variables), jax_batch(fields))
    nudged = dict(fields, images=_nudge(fields["images"], 1),
                  voxels=_nudge(fields["voxels"], 2))
    drifted = j16(to_jax(variables), jax_batch(nudged))
    model = port_module(MGAR, cfg16, variables=variables)
    got = make_eval_step(model)(batch_from_numpy(fields))
    return dict(cfg16=cfg16, fields=fields, variables=variables,
                ref32=_outputs(ref32), ref16=_outputs(ref16),
                drift=_outputs(drifted), got=_outputs(got), model=model,
                out=got)


def test_mgar_eval_matches_jax_bf16(mgar_runs):
    r = mgar_runs
    for name, got in r["got"].items():
        drift = _rel(r["drift"][name], r["ref16"][name])
        check_bf16(got, r["ref16"][name], r["ref32"][name], name, drift)
    # float32 out of the fusion net and the heads, as in JAX
    assert all(t.dtype == torch.float32 for t in r["got"].values())
    out, valid = r["out"], torch.from_numpy(r["fields"]["person_valid"])
    assert torch.all(out.a_theta[~valid] == 0)
    assert torch.all(torch.diagonal(out.a_theta, dim1=1, dim2=2)[valid] == 1)


def test_jax_bf16_drifts_past_half_the_gap_by_itself(mgar_runs):
    """Why bound 2 is held to the outputs where JAX's own drift allows it:
    JAX's bf16 MGAR, with 0.1% of its input values moved by one bf16 ulp,
    moves by more than half its bf16-vs-f32 gap on some outputs, and by
    more than the port's distance from it on the RGB features."""
    r = mgar_runs
    for n in r["ref16"]:          # the readings, with pytest -s
        print(f"{n}: JAX gap {_rel(r['ref16'][n], r['ref32'][n]):.3g}, "
              f"JAX drift {_rel(r['drift'][n], r['ref16'][n]):.3g}, port "
              f"{_rel(r['got'][n], r['ref16'][n]):.3g}")
    past = [n for n in r["ref16"]
            if _rel(r["ref16"][n], r["ref32"][n]) >= GAP_MIN
            and _rel(r["drift"][n], r["ref16"][n])
            > _rel(r["ref16"][n], r["ref32"][n]) / 2]
    assert "rgb_features" in past, past
    held = [n for n in r["ref16"] if n not in past
            and _rel(r["ref16"][n], r["ref32"][n]) >= GAP_MIN]
    # and bound 2 is held on the rest (test_mgar_eval_matches_jax_bf16),
    # the cardinality head among them
    assert "card" in held, (past, held)


def _det_runs(name, x_window):
    jcfg = tiny_voxel_cfg(name)
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    jb = with_rulebook(det_batch(jcfg, batch_size=2, seed=3,
                                 m=jcfg.max_voxels_per_stage[0]), jcfg)
    j32, j16 = jax_build(name, jcfg), jax_build(name, jcfg16)
    v = random_variables(j32, jb, train=False, seed=1)
    ref32 = jax.jit(lambda v, b: j32.apply(v, b, train=False))(to_jax(v),
                                                               jb)
    ref16 = jax.jit(lambda v, b: j16.apply(v, b, train=False))(to_jax(v),
                                                               jb)
    cfg = dataclasses.replace(port_cfg(jcfg16), x_window=x_window)
    model = load_jax_variables(build_detector(name, cfg, device="cpu"), v)
    with torch.no_grad():
        got = model.eval()(port_batch(jb))
    return got, ref16, ref32


@pytest.mark.parametrize("name,x_window", [("SECOND", False),
                                           ("CenterPoint", True)])
def test_detector_eval_matches_jax_bf16(name, x_window):
    """SECOND over the nbr maps (K3's plain version) and CenterPoint on the
    x-window path: VoxelBackbone8x and conv_out at bf16, the BEV trunk in
    float32 on the bf16-rounded map, the heads in float32."""
    got, ref16, ref32 = _det_runs(name, x_window)
    assert set(got) == set(ref16)
    for key in ref16:
        assert got[key].dtype == torch.float32
        check_bf16(got[key], ref16[key], ref32[key], f"{name} {key}")


# ---------------------------------------------------------------------------
# Training at bf16 (tests/test_torch_bf16_train.py holds it against JAX),
# and what still raises
# ---------------------------------------------------------------------------

def test_bf16_training_raises(mgar_runs):
    """(Its name from when bf16 training raised.) Two micro-steps of the
    bf16 MGAR at accumulation 2: finite losses and no zeroed gradients,
    the float32 parameters unmoved after the first and moved after the
    second, at the accumulation boundary."""
    model = copy.deepcopy(mgar_runs["model"])
    opt = make_optimizer(model.parameters(),
                         mgar_runs["cfg16"].train.stages[0], 4, 2, 0.1)
    step = make_train_step(model, opt, "L_total")
    batch = batch_from_numpy(mgar_runs["fields"])
    p0 = [p.detach().clone() for p in opt.params]
    for i in range(2):
        m = step(batch)
        assert float(m["nonfinite_grads"]) == 0.0
        assert np.isfinite(float(m["loss"]))
        moved = [not torch.equal(p, q) for p, q in zip(opt.params, p0)]
        assert any(moved) == (i == 1), i
    assert all(p.dtype == torch.float32 for p in opt.params)


def test_bf16_detector_training_and_other_families_raise():
    """(Its name from when PartA2 and VoxelNeXt raised at bf16.) One bf16
    train step of SECOND, PointPillar and PillarNet at the tiny configs
    (finite, the parameters moved, float32); PartA2 and VoxelNeXt build at
    bf16 with every sparse conv (UNetV2's and the residual encoder's, the
    strided conv_out included) at bf16, as the JAX modules' compute dtype
    (tests/test_torch_bf16_det_zoo_parta2.py and _next.py hold them to
    JAX)."""
    from multimodal_gar_tpu_torch.detection.detectors import DetectorConfig
    from multimodal_gar_tpu_torch.detection.train import (
        create_det_train_state, make_det_train_step)
    from tests.test_detection import tiny_pillar_cfg
    for name, cfg_fn in (("SECOND", tiny_voxel_cfg),
                         ("PointPillar", tiny_pillar_cfg),
                         ("PillarNet", tiny_pillar_cfg)):
        jcfg = dataclasses.replace(cfg_fn(name), dtype="bfloat16")
        model = build_detector(name, port_cfg(jcfg), device="cpu")
        state = create_det_train_state(model)
        p0 = [p.detach().clone() for p in state.params]
        jb = det_batch(jcfg, batch_size=2, seed=3,
                       m=jcfg.max_voxels_per_stage[0])
        metrics = make_det_train_step(model, state)(port_batch(
            with_rulebook(jb, jcfg) if name == "SECOND" else jb,
            with_rulebook=name == "SECOND"))
        assert float(metrics["nonfinite_grads"]) == 0.0, name
        assert np.isfinite(float(metrics["loss"])), name
        assert any(not torch.equal(p, q) for p, q in zip(state.params, p0))
        assert all(p.dtype == torch.float32 for p in state.params)
    from multimodal_gar_tpu_torch.models.sparse_backbone import (
        SparseConv, SparseConv3dDown)
    for name, n_sparse in (("PartA2", 28), ("VoxelNeXt", 32)):
        model = build_detector(name, DetectorConfig(name=name,
                                                    dtype="bfloat16"),
                               device="cpu")
        convs = [m for m in model.modules()
                 if isinstance(m, (SparseConv, SparseConv3dDown))]
        assert len(convs) == n_sparse, (name, len(convs))
        assert all(m.dtype == torch.bfloat16 for m in convs), name
        assert all(p.dtype == torch.float32 for p in model.parameters())


def test_sparse_conv_gradient_at_bf16_raises(sparse_scene):
    """(Its name from when a bf16 sparse conv had no backward.) The bf16
    sparse layer's gradients over the x-window kernel's plain version: a
    float32 d(features) from kernel C's plain version and a float32
    d(weights), kernel D's bf16 sum widened by the weights' cast."""
    from multimodal_gar_tpu_torch.ops.sparse_maps import backbone_maps
    s = sparse_scene
    maps = backbone_maps({k: torch.from_numpy(v) for k, v in
                          s["rb"].items()}, key_sorted=True)["nbr_0"]
    layer = SparseConvBlock(16, 16, device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16).train()
    feats = torch.from_numpy(s["feats"]).requires_grad_()
    launches = (subm_conv.subm_conv_dgrad_bf16.launches,
                sparse_wgrad.sparse_wgrad_bf16.launches)
    out = layer(feats, torch.from_numpy(s["rb"]["win_0"]), maps,
                torch.from_numpy(s["valid0"]))
    out.square().sum().backward()
    assert feats.grad.dtype == torch.float32
    assert layer.conv.weight.grad.dtype == torch.float32
    assert torch.count_nonzero(feats.grad) > 0
    assert torch.equal(layer.conv.weight.grad,
                       layer.conv.weight.grad.bfloat16().float())
    # the CPU runs the plain versions, never a kernel
    assert (subm_conv.subm_conv_dgrad_bf16.launches,
            sparse_wgrad.sparse_wgrad_bf16.launches) == launches


def test_other_dtypes_raise():
    xd, w2, sc, bi = (torch.from_numpy(a).half() for a in
                      stem_inputs_numpy((1, 5, 9, 20, 12)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        stem_conv.stem_conv(xd, w2, sc, bi)
    t = torch.zeros((1, 8, 16), dtype=torch.float16)
    for fn, maps in ((window_conv.window_conv,
                      torch.zeros((1, 8, 9), dtype=torch.int32)),
                     (subm_conv.subm_conv,
                      torch.full((1, 8, 27), -1, dtype=torch.int32))):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(t, maps, torch.zeros((27, 16, 16), dtype=torch.float16))
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float16"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        MGAR(cfg, device="cpu")
