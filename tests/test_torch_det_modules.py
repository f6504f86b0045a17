"""The port's voxel feature encoders, BEV modules and RoI-head functions
against the JAX package's (detection/{vfe,bev,roi_heads}.py), the RoI
sampler against its invariants, and loading a pcdet SECOND state dict.

Seeded numpy inputs, float32, held to 1e-4 of the largest reference value;
masks, counts and selections exactly. The flax transposed convs of the BEV
backbone are held at every upsample stride the configs use (1, 2, 4) and
below 1, and the BEV's d-major channel order through the pcdet loader."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_gar_tpu.detection.bev as jbev
import multimodal_gar_tpu.detection.roi_heads as jroi
import multimodal_gar_tpu.detection.vfe as jvfe
import multimodal_gar_tpu_torch.detection.bev as pbev
import multimodal_gar_tpu_torch.detection.roi_heads as proi
import multimodal_gar_tpu_torch.detection.vfe as pvfe
from multimodal_gar_tpu.detection.box_coders import ResidualCoder as JCoder
from multimodal_gar_tpu.models.sparse_backbone import SparseTensor as JST
from multimodal_gar_tpu_torch.detection.box_coders import ResidualCoder
from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
from tests.test_torch_det_common import port_cfg
from tests.test_torch_common import (assert_close, port_module,
                                     random_variables, to_jax)

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, what):
    assert_close(got.detach().numpy(), np.asarray(ref), TOL, what)


# ---------------------------------------------------------------------------
# voxel feature encoders
# ---------------------------------------------------------------------------

def _pillars(b=2, p=40, n=6, seed=0):
    rng = np.random.default_rng(seed)
    vox = rng.uniform([0, -8, -2, 0], [16, 8, 2, 1],
                      (b, p, n, 4)).astype(np.float32)
    num = rng.integers(1, n + 1, (b, p)).astype(np.int32)
    valid = np.ones((b, p), bool)
    valid[1, 30:] = False
    vox *= (np.arange(n)[None, None, :, None] < num[..., None, None])
    coords = np.stack([np.zeros((b, p)), rng.integers(0, 32, (b, p)),
                       rng.integers(0, 32, (b, p))], -1).astype(np.int32)
    return vox, coords, num, valid


def test_mean_vfe_and_pillar_vfe():
    vox, coords, num, valid = _pillars()
    _close(pvfe.mean_vfe(_t(vox), _t(num)), jvfe.mean_vfe(vox, num), "mean")
    for with_distance in (False, True):
        kw = dict(num_filters=(16, 32), voxel_size=(0.5, 0.5, 4.0),
                  point_cloud_range=(0.0, -8.0, -2.0, 16.0, 8.0, 2.0),
                  with_distance=with_distance)
        jmod = jvfe.PillarVFE(**kw)
        args = tuple(jnp.asarray(a) for a in (vox, coords, num, valid))
        variables = random_variables(jmod, *args, train=False, seed=1)
        pmod = port_module(pvfe.PillarVFE, **kw, variables=variables)
        ref = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
            to_jax(variables), *args)
        with torch.no_grad():
            _close(pmod(*map(_t, (vox, coords, num, valid))), ref, "eval")
        ref, upd = jax.jit(lambda v, *a: jmod.apply(
            v, *a, train=True, mutable=["batch_stats"]))(to_jax(variables),
                                                         *args)
        got = pmod.train()(*map(_t, (vox, coords, num, valid)))
        _close(got, ref, "train")
        _close(pmod.pfn0.norm.running_var,
               upd["batch_stats"]["pfn0"]["norm"]["BatchNorm_0"]["var"],
               "masked running var")


def test_dynamic_mean_vfe():
    rng = np.random.default_rng(2)
    pts = rng.uniform([-1, -9, -2, 0], [17, 9, 2, 1],
                      (2, 300, 4)).astype(np.float32)
    pv = rng.uniform(size=(2, 300)) > 0.1
    args = ((0.5, 0.5, 0.5), (0.0, -8.0, -2.0, 16.0, 8.0, 2.0), (32, 32, 8))
    for cap in (40, 400):
        ref = jax.jit(lambda p, v: jvfe.dynamic_mean_vfe(p, v, *args, cap))(
            pts, pv)
        got = pvfe.dynamic_mean_vfe(_t(pts), _t(pv), *args, cap)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        _close(got[0], ref[0], f"features, cap {cap}")


# ---------------------------------------------------------------------------
# BEV
# ---------------------------------------------------------------------------

def test_sparse_to_dense_bev_and_pillar_scatter():
    rng = np.random.default_rng(3)
    shape = (3, 10, 12)
    keys = np.stack([rng.choice(360, 50, replace=False) for _ in range(2)])
    coords = np.stack(np.unravel_index(keys, shape), -1).astype(np.int32)
    valid = np.ones((2, 50), bool)
    valid[0, 40:] = False
    feats = rng.normal(size=(2, 50, 5)).astype(np.float32)
    ref = jbev.sparse_to_dense_bev(JST(jnp.asarray(feats),
                                       jnp.asarray(coords),
                                       jnp.asarray(valid), shape))
    got = pbev.sparse_to_dense_bev(SparseTensor(_t(feats), _t(coords),
                                                _t(valid), shape))
    # NCHW in the port, the same d-major channel order
    _close(got.permute(0, 2, 3, 1), ref, "bev")
    c2 = coords.copy()
    c2[..., 0] = 0
    ref = jbev.pillar_scatter(feats, c2, valid, (12, 10))
    got = pbev.pillar_scatter(_t(feats), _t(c2), _t(valid), (12, 10))
    _close(got.permute(0, 2, 3, 1), ref, "pillars")


@pytest.mark.parametrize("ups", [(1, 2), (1, 2, 4), (0.5, 1, 2, 4)],
                         ids=["second", "pillars", "strided_and_extra"])
def test_base_bev_backbone_train_and_eval(ups):
    n = 3 if len(ups) > 2 else 2
    kw = dict(layer_nums=(1,) * n, layer_strides=(1,) + (2,) * (n - 1),
              num_filters=(8,) * n, upsample_strides=ups,
              num_upsample_filters=(6,) * min(len(ups), n))
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 5)).astype(
        np.float32)
    jmod = jbev.BaseBEVBackbone(**kw)
    variables = random_variables(jmod, jnp.asarray(x), train=False, seed=2)
    pmod = port_module(pbev.BaseBEVBackbone, 5, *kw.values(),
                       variables=variables)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        to_jax(variables), x)
    with torch.no_grad():
        _close(pmod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), ref,
               "eval")
    ref, upd = jax.jit(lambda v, a: jmod.apply(
        v, a, train=True, mutable=["batch_stats"]))(to_jax(variables), x)
    got = pmod.train()(_t(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), ref, "train")
    assert pmod.num_bev_features == ref.shape[-1] == got.shape[1]
    last = "deblock_extra_bn" if len(ups) > n else f"deblock{n - 1}_bn"
    _close(getattr(pmod, last).running_mean,
           upd["batch_stats"][last]["mean"], "statistics")


def test_conv2d_collapse():
    x = np.random.default_rng(5).normal(size=(2, 6, 6, 12)).astype(
        np.float32)
    jmod = jbev.Conv2DCollapse(7)
    variables = random_variables(jmod, jnp.asarray(x), seed=3)
    pmod = port_module(pbev.Conv2DCollapse, 12, 7, variables=variables)
    ref = jax.jit(jmod.apply)(to_jax(variables), x)
    with torch.no_grad():
        _close(pmod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), ref,
               "collapse")


# ---------------------------------------------------------------------------
# RoI heads
# ---------------------------------------------------------------------------

def _rois(n, seed, spread=8.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.uniform(-1, 1, (n, 1)),
                           rng.uniform(0.5, 4, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def test_roi_box_functions():
    rois, gt = _rois(30, 6), _rois(30, 7)
    gt[:10] = rois[:10] + np.random.default_rng(8).normal(
        0, 0.1, (10, 7)).astype(np.float32)
    ct = jroi.canonical_gt_transform(jnp.asarray(rois), jnp.asarray(gt))
    _close(proi.canonical_gt_transform(_t(rois), _t(gt)), ct, "canonical")
    reg = np.random.default_rng(9).normal(0, 0.2, (30, 7)).astype(np.float32)
    _close(proi.decode_roi_boxes(ResidualCoder(), _t(reg), _t(rois)),
           jroi.decode_roi_boxes(JCoder(), jnp.asarray(reg),
                                 jnp.asarray(rois)), "decode")
    valid = (np.arange(30) % 3 != 0).astype(np.int32)
    for corner in (True, False):
        ref = jroi.roi_box_loss(JCoder(), *map(jnp.asarray, (
            reg, rois, ct, gt, valid)), 1.0, 1.0, corner)
        got = proi.roi_box_loss(ResidualCoder(), _t(reg), _t(rois),
                                _t(np.asarray(ct)), _t(gt), _t(valid), 1.0,
                                1.0, corner)
        for k in ref:
            _close(got[k], ref[k], k)
    labels = np.where(np.arange(30) % 4 == 0, -1.0,
                      np.linspace(0, 1, 30)).astype(np.float32)
    _close(proi.roi_cls_loss(_t(reg[:, 0]), _t(labels)),
           jroi.roi_cls_loss(reg[:, 0], labels), "cls loss")
    _close(proi.roi_grid_points(_t(rois), 3),
           jroi.roi_grid_points(jnp.asarray(rois), 3), "grid points")


def test_proposal_layer():
    from multimodal_gar_tpu.detection.post import NMSConfig
    rng = np.random.default_rng(10)
    boxes = np.stack([_rois(80, 11, 5.0), _rois(80, 12, 5.0)])
    cls = rng.normal(0, 2, (2, 80, 3)).astype(np.float32)
    jcfg = NMSConfig(nms_thresh=0.5, nms_pre_maxsize=48, nms_post_maxsize=20,
                     score_thresh=0.0)
    ref = jax.jit(lambda c, b: jroi.proposal_layer(c, b, jcfg))(cls, boxes)
    got = proi.proposal_layer(_t(cls), _t(boxes), port_cfg(jcfg))
    v = np.asarray(ref[3])
    np.testing.assert_array_equal(got[3].numpy(), v)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[0][_t(v)], np.asarray(ref[0])[v], "rois")
    _close(got[1], ref[1], "scores")


def _sampler_case(n_fg, n_hard, n_easy, n_pad):
    """RoIs at IoU 1 (fg), ~0.3 (hard bg) and 0 (easy bg) with the one GT,
    and padded RoIs."""
    gt = np.array([[10.0, 10.0, 0.0, 4.0, 2.0, 1.5, 0.0]], np.float32)
    rows = ([gt[0]] * n_fg
            + [[11.9, 10.0, 0.0, 4.0, 2.0, 1.5, 0.0]] * n_hard
            + [[50.0, 50.0, 0.0, 4.0, 2.0, 1.5, 0.0]] * n_easy
            + [[0.0] * 7] * n_pad)
    n = len(rows)
    valid = np.arange(n) < n - n_pad
    # distinct scores, so that the rows a sampling picks show
    return (np.asarray(rows, np.float32), np.linspace(0.1, 0.9, n).astype(
        np.float32), np.ones(n, np.int32), valid, gt)


@pytest.mark.parametrize("case", [(20, 6, 10, 4), (2, 3, 40, 0),
                                  (0, 0, 5, 3)],
                         ids=["fg_quota_full", "few_fg", "bg_only_padded"])
def test_roi_sampler_invariants(case):
    """Counts, thresholds, padding and labels of one sampling, for the
    port's generator: fg up to the quota, hard before easy at
    hard_bg_ratio, fg first, each RoI at most once, padded slots masked."""
    cfg = proi.RoISamplerConfig(roi_per_image=16, fg_ratio=0.5,
                                hard_bg_ratio=0.8)
    rois, scores, labels, valid, gt = _sampler_case(*case)
    gen = torch.Generator().manual_seed(5)
    out = proi.sample_rois_for_rcnn(gen, cfg, _t(rois), _t(scores),
                                    _t(labels), _t(valid), _t(gt),
                                    _t(np.array([1], np.int32)),
                                    _t(np.array([True])))
    ok = out["roi_valid"].numpy()
    iou = out["gt_iou_of_rois"].numpy()
    n_fg, n_hard, n_easy, _ = case
    fg = iou >= min(cfg.reg_fg_thresh, cfg.cls_fg_thresh)
    assert (fg & ok).sum() == min(n_fg, 8)
    n_bg = min(16 - (fg & ok).sum(), n_hard + n_easy)
    assert ok.sum() == (fg & ok).sum() + n_bg
    hard = ok & ~fg & (iou >= cfg.cls_bg_thresh_lo)
    assert hard.sum() == min(n_hard, n_bg)
    # fg slots first, padded slots last and zero
    order = np.concatenate([np.nonzero(fg & ok)[0], np.nonzero(~fg & ok)[0]])
    np.testing.assert_array_equal(np.sort(order), np.arange(ok.sum()))
    assert np.all(np.nonzero(fg & ok)[0] < np.nonzero(~fg & ok)[0].min()) \
        if (fg & ok).any() and (~fg & ok).any() else True
    assert not out["rois"].numpy()[~ok].any()
    assert np.all(out["rcnn_cls_labels"].numpy()[~ok] == -1)
    lab = out["rcnn_cls_labels"].numpy()[ok]
    assert np.all((lab >= 0) & (lab <= 1))
    np.testing.assert_array_equal(out["reg_valid_mask"].numpy(),
                                  (iou > cfg.reg_fg_thresh) & ok)
    # each RoI at most once: the sampled boxes are those of distinct rows
    assert out["roi_labels"].numpy()[~ok].sum() == 0


def test_roi_sampler_follows_its_generator():
    cfg = proi.RoISamplerConfig(roi_per_image=16)
    args = [_t(a) for a in _sampler_case(20, 6, 10, 4)[:4]]
    gt = (_t(_sampler_case(1, 0, 0, 0)[4]), _t(np.array([1], np.int32)),
          _t(np.array([True])))

    def draw(seed):
        return proi.sample_rois_for_rcnn(
            torch.Generator().manual_seed(seed), cfg, *args, *gt)
    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


# ---------------------------------------------------------------------------
# a pcdet SECOND checkpoint, loaded two ways
# ---------------------------------------------------------------------------

def test_pcdet_second_state_dict_loads_the_same_into_both():
    """A fabricated pcdet SECOND state dict (tests/test_detection_convert.py)
    through the JAX package's converter into the JAX detector, and through
    the port's entry (detection/convert.py: load_pcdet_second) into the
    port's: the same eval outputs. This holds the BEV's d-major channel
    order (the first BEV conv's permuted input) and the deblocks' taps."""
    from multimodal_gar_tpu.detection import build_detector as jbuild
    from multimodal_gar_tpu.detection.convert import convert_pcdet_second
    from multimodal_gar_tpu_torch.detection import build_detector
    from multimodal_gar_tpu_torch.detection.convert import load_pcdet_second
    from tests.test_torch_det_common import compare_tree, port_batch, with_rulebook
    from tests.test_detection import det_batch, tiny_voxel_cfg
    from tests.test_detection_convert import _fabricate_state_dict
    # depth 2 after conv_out, so that the channel order matters
    jcfg = dataclasses.replace(tiny_voxel_cfg("SECOND"),
                               point_cloud_range=(0.0, -8.0, -2.5, 16.0, 8.0,
                                                  2.5),
                               voxel_size=(0.25, 0.25, 0.125))
    jmodel = jbuild("SECOND", jcfg)
    jb = with_rulebook(det_batch(jcfg, batch_size=1, seed=4, m=256), jcfg)
    init = random_variables(jmodel, jb, train=False, seed=0)
    sd = _fabricate_state_dict(to_jax(init), jcfg.bev_layer_nums)
    new_vars, loaded = convert_pcdet_second(sd, init, jcfg.bev_layer_nums)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        to_jax(new_vars), jb)
    model = build_detector("SECOND", port_cfg(jcfg), device="cpu")
    assert model.trunk.backbone_2d.block0_down_conv.in_channels == 2 * 128
    assert load_pcdet_second(model, sd, jcfg.bev_layer_nums) == loaded
    with torch.no_grad():
        got = model.eval()(port_batch(jb))
    compare_tree(got, jax.device_get(ref), "pcdet SECOND")
