"""The port's extras (detection/extras.py: AnchorHeadMulti,
DynamicPillarVFE, BaseBEVBackboneV1, PillarRes18Backbone,
FocalSparseConv) and 2D image backbones (models/backbones2d.py: VGG16,
VGG19, InceptionV3Features) against the JAX package's, on numpy-seeded
inputs and weights: outputs to 1e-4 of their largest reference value,
integer outputs (pillar coords, active sets, top-k sets) exactly. The
sparse modules are also held in training, gradients and new statistics
included, against a float64 JAX run under a fixed linear loss.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.detection.anchors import AnchorClassConfig as JaxACC
from multimodal_gar_tpu.detection.dense_heads import (
    AnchorHeadConfig as JaxAHC)
from multimodal_gar_tpu.models.sparse_backbone import SparseTensor as JaxST
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
from multimodal_gar_tpu_torch.utils.testing import sparse_input_numpy
from tests.test_torch_common import assert_close, random_variables, to_jax
from tests.test_torch_det_common import expected_tensors, port_cfg

TOL = 1e-4
CPU = dict(device="cpu")


def _gen():
    return torch.Generator().manual_seed(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


# ---------------------------------------------------------------------------
# AnchorHeadMulti
# ---------------------------------------------------------------------------

ANCHORS = (
    JaxACC("Car", ((3.9, 1.6, 1.56),), (0.0, 1.57), (-1.0,), False, 2, 0.55,
           0.4),
    JaxACC("Pedestrian", ((0.8, 0.6, 1.73),), (0.0, 1.57), (-0.6,), False, 2,
           0.5, 0.35),
    JaxACC("Cyclist", ((1.76, 0.6, 1.73),), (0.0, 1.57), (-0.6,), False, 2,
           0.5, 0.35))
CLASSES = ("Car", "Pedestrian", "Cyclist")
GROUPS = (("Car",), ("Pedestrian", "Cyclist"))
PC_RANGE = (0, -8, -2, 16, 8, 2)


@pytest.fixture(scope="module")
def head_multi():
    from multimodal_gar_tpu.detection.extras import AnchorHeadMulti
    jm = AnchorHeadMulti(head_cfg=JaxAHC(num_class=1), class_groups=GROUPS,
                         anchors=ANCHORS, grid_size=(16, 16),
                         point_cloud_range=PC_RANGE, shared_channels=8)
    rng = np.random.default_rng(4)
    bev = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(bev), seed=2)
    gt = np.asarray([[[4.0, 0.0, -0.2, 3.9, 1.6, 1.56, 0.0],
                      [8.0, 2.0, 0.3, 0.8, 0.6, 1.73, 0.0],
                      [12.0, -3.0, 0.2, 1.76, 0.6, 1.73, 1.0]],
                     [[6.0, 4.0, 0.0, 0.8, 0.6, 1.73, 0.5],
                      [10.0, -2.0, 0.2, 1.76, 0.6, 1.73, 0.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]], np.float32)
    gtc = np.asarray([[1, 2, 3], [2, 3, 0]], np.int32)
    gtv = np.asarray([[True, True, True], [True, True, False]])
    def run(v, bev, gt, gtc, gtv):
        preds = jm.apply(v, bev)
        return (preds, jm.loss(preds, gt, gtc, gtv, CLASSES),
                *jm.decode(preds, CLASSES))
    ref = jax.jit(run)(to_jax(variables), *map(jnp.asarray,
                                                (bev, gt, gtc, gtv)))
    return dict(jm=jm, bev=bev, variables=variables, gt=(gt, gtc, gtv),
                ref=jax.device_get(ref))


def test_anchor_head_multi_matches_jax(head_multi):
    from multimodal_gar_tpu_torch.detection.extras import AnchorHeadMulti
    s = head_multi
    jm = s["jm"]
    model = AnchorHeadMulti(16, port_cfg(jm.head_cfg), GROUPS,
                            port_cfg(ANCHORS), (16, 16), PC_RANGE,
                            shared_channels=8, generator=_gen(), **CPU)
    load_jax_variables(model, s["variables"]).eval()
    preds_ref, losses_ref, cls_ref, boxes_ref = s["ref"]
    with torch.no_grad():
        preds = model(_nchw(s["bev"]))
        assert len(preds["heads"]) == 2
        for got, ref in zip(preds["heads"], preds_ref["heads"]):
            assert set(got) == set(ref)
            for k in ref:
                assert_close(got[k].numpy(), ref[k], TOL, k)
        gt, gtc, gtv = (_t(a) for a in s["gt"])
        losses = model.loss(preds, gt, gtc, gtv, CLASSES)
        assert set(losses) == {"head0_rpn_loss", "head1_rpn_loss",
                               "rpn_loss"}
        for k, v in losses_ref.items():
            assert_close(losses[k].numpy(), v, TOL, k)
        cls, boxes = model.decode(preds, CLASSES)
    np.testing.assert_array_equal(cls.numpy() == -1e4,
                                  np.asarray(cls_ref) == -1e4)
    assert_close(cls.numpy(), cls_ref, TOL, "decoded classes")
    assert_close(boxes.numpy(), boxes_ref, TOL, "decoded boxes")
    # head 0 scores only Car: its Pedestrian / Cyclist slots are the floor
    assert bool((cls[:, :8 * 8 * 2, 1:] == -1e4).all())


# ---------------------------------------------------------------------------
# DynamicPillarVFE
# ---------------------------------------------------------------------------

def _raw_points(seed=0, n=300):
    """Two items of points in and around PC_RANGE (a few outside, a few
    padded), several per pillar of a 1 m grid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1, -9, -2, 0], [17, 9, 2, 1],
                      size=(2, n, 4)).astype(np.float32)
    pts[:, :40, :2] = np.floor(pts[:, :40, :2]) + 0.5     # shared pillars
    valid = np.ones((2, n), bool)
    valid[1, -25:] = False
    return pts, valid


@pytest.mark.parametrize("max_pillars", [64, 400])
def test_dynamic_pillar_vfe_matches_jax(max_pillars):
    """At a cap below the occupied pillars (the smallest keys kept) and
    above them (padded slots zero); two PFN layers, so the per-point
    segment max is concatenated once."""
    from multimodal_gar_tpu.detection.extras import DynamicPillarVFE as JV
    from multimodal_gar_tpu_torch.detection.extras import DynamicPillarVFE
    kw = dict(num_filters=(8, 16), voxel_size=(1.0, 1.0, 4.0),
              point_cloud_range=PC_RANGE, max_pillars=max_pillars)
    pts, valid = _raw_points()
    jm = JV(**kw)
    variables = random_variables(jm, jnp.asarray(pts), jnp.asarray(valid),
                                 train=False, seed=3)
    ref = jax.device_get(jax.jit(partial(jm.apply, train=False))(
        to_jax(variables), jnp.asarray(pts), jnp.asarray(valid)))
    model = load_jax_variables(
        DynamicPillarVFE(generator=_gen(), **kw, **CPU), variables).eval()
    with torch.no_grad():
        feats, coords, uvalid = model(_t(pts), _t(valid))
    np.testing.assert_array_equal(uvalid.numpy(), ref[2])
    np.testing.assert_array_equal(coords.numpy(), ref[1])
    assert_close(feats.numpy(), ref[0], TOL, "pillar features")
    assert (int(uvalid[0].sum()) == max_pillars) == (max_pillars == 64)


# ---------------------------------------------------------------------------
# BaseBEVBackboneV1
# ---------------------------------------------------------------------------

def test_base_bev_backbone_v1_matches_jax():
    from multimodal_gar_tpu.detection.extras import BaseBEVBackboneV1 as JB
    from multimodal_gar_tpu_torch.detection.extras import BaseBEVBackboneV1
    kw = dict(layer_nums=(2, 1), num_filters=(8, 16),
              upsample_strides=(1, 2), num_upsample_filters=(8, 8))
    rng = np.random.default_rng(5)
    m1 = rng.normal(size=(2, 12, 10, 6)).astype(np.float32)
    m2 = rng.normal(size=(2, 6, 5, 12)).astype(np.float32)
    jm = JB(**kw)
    maps = [jnp.asarray(m1), jnp.asarray(m2)]
    variables = random_variables(jm, maps, train=False, seed=4)
    ref = np.asarray(jm.apply(to_jax(variables), maps, train=False))
    model = load_jax_variables(BaseBEVBackboneV1(
        (6, 12), generator=_gen(), **kw, **CPU), variables).eval()
    with torch.no_grad():
        out = model([_nchw(m1), _nchw(m2)])
    assert model.num_bev_features == 16
    assert_close(out.permute(0, 2, 3, 1).numpy(), ref, TOL, "BEV V1")


# ---------------------------------------------------------------------------
# PillarRes18Backbone and FocalSparseConv
# ---------------------------------------------------------------------------

def _sparse_ref(jmodel, jst, variables, proj_fn):
    """(eval outputs, training outputs, gradients, new statistics) of a
    sparse module under the loss sum(proj * training features), one
    float64 JAX jit."""
    def run(variables, st):
        ev = jmodel.apply(variables, st, train=False)

        def loss_fn(params):
            out, upd = jmodel.apply(
                {"params": params,
                 "batch_stats": variables.get("batch_stats", {})},
                st, train=True, mutable=["batch_stats"])
            return proj_fn(out), (out, upd.get("batch_stats", {}))
        (_, (tr, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return ev, tr, grads, stats

    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), to_jax(variables))
        st64 = jst.replace(features=jnp.asarray(jst.features, jnp.float64))
        return jax.device_get(jax.jit(run)(wide, st64))


def _compare_st(got, ref, what):
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v, f"{what} valid")
    np.testing.assert_array_equal(got.coords.numpy()[v],
                                  np.asarray(ref.coords)[v], f"{what} coords")
    assert got.spatial_shape == tuple(ref.spatial_shape)
    assert_close(got.features.detach().numpy(), np.asarray(ref.features),
                 TOL, what)


def _check_grads(model, grads, stats, what):
    want = expected_tensors(model, grads, stats)
    for name, buf in model.named_buffers():
        assert_close(buf.numpy(), want[name].numpy(), TOL, f"{what} {name}")
    for name, p in model.named_parameters():
        assert_close(p.grad.numpy(), want[name].numpy(), TOL,
                     f"{what} grad {name}")


PR18_CAPS = (60, 30, 12, 4)
PR18_CH = (8, 16, 16, 32)


@pytest.fixture(scope="module")
def pillar_res18():
    from multimodal_gar_tpu.detection.extras import PillarRes18Backbone as J
    f, c, v, shape = sparse_input_numpy()
    jst = JaxST(jnp.asarray(f), jnp.asarray(c), jnp.asarray(v), shape)
    jm = J(channels=PR18_CH, max_voxels_per_stage=PR18_CAPS)
    variables = random_variables(jm, jst, train=False, seed=1)
    rng = np.random.default_rng(9)
    proj = {f"x_conv{i + 1}": rng.normal(size=(2, cap, ch))
            for i, (cap, ch) in enumerate(zip((60,) + PR18_CAPS[1:],
                                              PR18_CH))}
    ref = _sparse_ref(jm, jst, variables, lambda ms: sum(
        jnp.sum(ms[k].features * p) for k, p in proj.items()))
    return dict(variables=variables, ref=ref, proj=proj,
                st=SparseTensor(_t(f), _t(c), _t(v), shape))


def _pillar_res18_port():
    from multimodal_gar_tpu_torch.detection.extras import PillarRes18Backbone
    return PillarRes18Backbone(8, PR18_CH, PR18_CAPS, generator=_gen(), **CPU)


def test_pillar_res18_backbone_matches_jax(pillar_res18):
    s = pillar_res18
    ev, _, _, _ = s["ref"]
    model = load_jax_variables(_pillar_res18_port(), s["variables"]).eval()
    with torch.no_grad():
        ms = model(s["st"])
    assert set(ms) == set(ev)
    for k in ev:
        _compare_st(ms[k], ev[k], f"eval {k}")
    assert ms["x_conv4"].spatial_shape == (1, 2, 2)
    # the strided stages' caps cut sites off
    for i in (1, 2):
        assert bool((ms[f"x_conv{i + 1}"].valid.sum(1) == PR18_CAPS[i]).all())


def test_pillar_res18_backbone_trains_as_jax(pillar_res18):
    s = pillar_res18
    _, tr, grads, stats = s["ref"]
    model = load_jax_variables(_pillar_res18_port(), s["variables"]).train()
    ms = model(s["st"])
    for k in tr:
        _compare_st(ms[k], tr[k], f"train {k}")
    loss = sum((ms[k].features * torch.from_numpy(p).float()).sum()
               for k, p in s["proj"].items())
    loss.backward()
    _check_grads(model, grads, stats, "PillarRes18")


@pytest.fixture(scope="module")
def focal():
    from multimodal_gar_tpu.detection.extras import FocalSparseConv as J
    f, c, v, shape = sparse_input_numpy(seed=2, m=48, c=8, shape=(5, 8, 8))
    # item 0 has more active sites than top_k, item 1 fewer: -inf scores
    # fill its tail
    v[1, 20:] = False
    c[1, 20:] = -1
    f[1, 20:] = 0.0
    jst = JaxST(jnp.asarray(f), jnp.asarray(c), jnp.asarray(v), shape)
    jm = J(out_channels=16, top_k=36)
    variables = random_variables(jm, jst, train=False, seed=6)
    proj = np.random.default_rng(7).normal(size=(2, 36, 16))
    pimp = np.random.default_rng(8).normal(size=(2, 48))
    ref = _sparse_ref(jm, jst, variables, lambda out: jnp.sum(
        out[0].features * proj) + jnp.sum(out[1] * pimp))
    return dict(variables=variables, ref=ref, proj=proj, pimp=pimp,
                st=SparseTensor(_t(f), _t(c), _t(v), shape))


def test_focal_sparse_conv_matches_jax(focal):
    from multimodal_gar_tpu_torch.detection.extras import FocalSparseConv
    s = focal
    (ev_st, ev_imp), (tr_st, tr_imp), grads, stats = s["ref"]
    assert np.asarray(ev_st.valid).sum(1).tolist() == [36, 20]
    model = load_jax_variables(FocalSparseConv(
        8, 16, 36, generator=_gen(), **CPU), s["variables"]).eval()
    with torch.no_grad():
        new, imp = model(s["st"])
    assert_close(imp.numpy(), ev_imp, TOL, "importance")
    _compare_st(new, ev_st, "focal eval")
    model.train()
    new, imp = model(s["st"])
    assert_close(imp.detach().numpy(), tr_imp, TOL, "importance (train)")
    _compare_st(new, tr_st, "focal train")
    loss = (new.features * torch.from_numpy(s["proj"]).float()).sum() \
        + (imp * torch.from_numpy(s["pimp"]).float()).sum()
    loss.backward()
    _check_grads(model, grads, stats, "FocalSparseConv")


# ---------------------------------------------------------------------------
# models/backbones2d.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,size", [("VGG16", 64), ("VGG19", 64),
                                       ("InceptionV3Features", 99)])
def test_backbones2d_match_jax(name, size):
    import multimodal_gar_tpu.models.backbones2d as jb
    import multimodal_gar_tpu_torch.models.backbones2d as pb
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, size, size + 6, 3)).astype(np.float32)
    jm = getattr(jb, name)()
    kw = {} if name.startswith("VGG") else dict(train=False)
    variables = random_variables(jm, jnp.asarray(x), seed=12, **kw)
    ref = jax.device_get(jax.jit(partial(jm.apply, **kw))(
        to_jax(variables), jnp.asarray(x)))
    model = load_jax_variables(getattr(pb, name)(generator=_gen(), **CPU),
                               variables).eval()
    with torch.no_grad():
        out = model(_t(x))
    assert len(out) == len(ref)
    for i, (got, want) in enumerate(zip(out, ref)):
        assert_close(got.numpy(), want, TOL, f"{name} output {i}")
    if name == "InceptionV3Features":
        assert out[0].shape[-1] == 288 and out[1].shape[-1] == 768


@pytest.mark.parametrize("name", ["AnchorHeadMulti", "DynamicPillarVFE",
                                  "BaseBEVBackboneV1", "PillarRes18Backbone",
                                  "FocalSparseConv", "InceptionV3Features"])
def test_new_modules_round_trip_through_the_flax_layout(name):
    """export_variables then convert_variables gives every tensor back."""
    import multimodal_gar_tpu_torch.detection.extras as ex
    import multimodal_gar_tpu_torch.models.backbones2d as b2
    from multimodal_gar_tpu_torch.convert import (convert_variables,
                                                  export_variables)
    kw = dict(generator=_gen(), **CPU)
    model = {
        "AnchorHeadMulti": lambda: ex.AnchorHeadMulti(
            16, port_cfg(JaxAHC(num_class=1)), GROUPS, port_cfg(ANCHORS),
            (16, 16), PC_RANGE, shared_channels=8, **kw),
        "DynamicPillarVFE": lambda: ex.DynamicPillarVFE((8, 16), **kw),
        "BaseBEVBackboneV1": lambda: ex.BaseBEVBackboneV1(
            (6, 12), (1, 1), (8, 16), (1, 2), (8, 8), **kw),
        "PillarRes18Backbone": _pillar_res18_port,
        "FocalSparseConv": lambda: ex.FocalSparseConv(8, 16, 4, **kw),
        "InceptionV3Features": lambda: b2.InceptionV3Features(**kw),
    }[name]()
    back = convert_variables(export_variables(model), model)
    for k, t in model.state_dict().items():
        assert torch.equal(back[k], t), k
