"""The port's detection losses, box coders, anchor targets, dense heads and
post-processing against the JAX package's (train/loss_lib.py,
detection/{box_coders,target_assign,dense_heads,post}.py).

Seeded numpy inputs, float32, held to 1e-4 of the largest reference value;
target labels, selections and validity masks exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_gar_tpu.detection.box_coders as jcod
import multimodal_gar_tpu.detection.dense_heads as jdh
import multimodal_gar_tpu.detection.post as jpost
import multimodal_gar_tpu.detection.target_assign as jta
import multimodal_gar_tpu.ops.boxes3d as jb3
import multimodal_gar_tpu.train.loss_lib as jloss
import multimodal_gar_tpu_torch.detection.box_coders as pcod
import multimodal_gar_tpu_torch.detection.dense_heads as pdh
import multimodal_gar_tpu_torch.detection.post as ppost
import multimodal_gar_tpu_torch.detection.target_assign as pta
import multimodal_gar_tpu_torch.train.loss_lib as ploss
from tests.test_torch_det_common import compare_tree, port_cfg
from tests.test_detection import tiny_voxel_cfg
from tests.test_torch_common import (assert_close, port_module,
                                     random_variables, to_jax)

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, what):
    assert_close(got.detach().numpy(), np.asarray(ref), TOL, what)


def _gt(b=2, g=5, seed=0, classes=2, lo=(1, -6), hi=(15, 6)):
    rng = np.random.default_rng(seed)
    gt = np.zeros((b, g, 7), np.float32)
    gt[..., 0] = rng.uniform(lo[0], hi[0], (b, g))
    gt[..., 1] = rng.uniform(lo[1], hi[1], (b, g))
    gt[..., 2] = rng.uniform(-0.5, 0.5, (b, g))
    gt[..., 3:6] = rng.uniform(0.5, 4.0, (b, g, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    gtc = rng.integers(1, classes + 1, (b, g)).astype(np.int32)
    gtv = np.ones((b, g), bool)
    gtv[:, -1] = False
    return gt, gtc, gtv


# ---------------------------------------------------------------------------
# loss library
# ---------------------------------------------------------------------------

def test_loss_lib():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (3, 50, 4)).astype(np.float32)
    targets = (rng.uniform(size=(3, 50, 4)) > 0.7).astype(np.float32)
    w = rng.uniform(size=(3, 50)).astype(np.float32)
    _close(ploss.sigmoid_focal_loss(_t(logits), _t(targets), _t(w)),
           jloss.sigmoid_focal_loss(logits, targets, w), "focal")
    a, b = (rng.normal(size=(3, 50, 7)).astype(np.float32) * 0.3
            for _ in range(2))
    _close(ploss.smooth_l1_loss(_t(a), _t(b), _t(w)),
           jloss.smooth_l1_loss(a, b, w), "smooth l1")
    _close(ploss.l1_loss(_t(a), _t(b), _t(w)), jloss.l1_loss(a, b, w), "l1")
    oh = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 50))]
    _close(ploss.weighted_cross_entropy(_t(logits), _t(oh), _t(w)),
           jloss.weighted_cross_entropy(logits, oh, w), "ce")
    boxes, gt = _gt(1, 30, 1)[0][0], _gt(1, 30, 2)[0][0]
    _close(ploss.corner_loss(_t(boxes), _t(gt)),
           jloss.corner_loss(jnp.asarray(boxes), jnp.asarray(gt)), "corner")
    hm = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    ght = np.where(rng.uniform(size=hm.shape) > 0.95, 1.0,
                   rng.uniform(size=hm.shape) * 0.9).astype(np.float32)
    _close(ploss.gaussian_focal_loss(_t(hm), _t(ght)),
           jloss.gaussian_focal_loss(hm, ght), "gaussian focal")
    gen = ploss.set_random_seed(3)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(3)))


# ---------------------------------------------------------------------------
# box coders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sincos", [False, True])
def test_residual_coder(sincos):
    anchors = _gt(1, 40, 3)[0][0]
    boxes = _gt(1, 40, 4)[0][0]
    jc, pc = jcod.ResidualCoder(encode_angle_by_sincos=sincos), \
        pcod.ResidualCoder(encode_angle_by_sincos=sincos)
    enc = jc.encode(jnp.asarray(boxes), jnp.asarray(anchors))
    _close(pc.encode(_t(boxes), _t(anchors)), enc, "encode")
    _close(pc.decode(_t(enc), _t(anchors)),
           jc.decode(enc, jnp.asarray(anchors)), "decode")
    assert pc.full_code_size == jc.full_code_size


def test_previous_and_point_coders():
    anchors, enc = _gt(1, 30, 5)[0][0], _gt(1, 30, 6)[0][0] * 0.1
    _close(pcod.PreviousResidualDecoder().decode(_t(enc), _t(anchors)),
           jcod.PreviousResidualDecoder().decode(enc, anchors), "previous")
    gt, cls, _ = _gt(1, 30, 7, classes=3)
    pts = gt[0, :, :3] + 0.3
    for mean in (True, False):
        jc = jcod.PointResidualCoder(use_mean_size=mean)
        pc = pcod.PointResidualCoder(use_mean_size=mean)
        e = jc.encode(jnp.asarray(gt[0]), jnp.asarray(pts),
                      jnp.asarray(cls[0]))
        _close(pc.encode(_t(gt[0]), _t(pts), _t(cls[0])), e, "point enc")
        _close(pc.decode(_t(e), _t(pts), _t(cls[0])),
               jc.decode(e, jnp.asarray(pts), jnp.asarray(cls[0])),
               "point dec")


# ---------------------------------------------------------------------------
# anchors and target assignment
# ---------------------------------------------------------------------------

def _anchor_sets(cfg=None):
    cfg = cfg or tiny_voxel_cfg()
    args = (cfg.grid_size[:2], cfg.point_cloud_range)
    return (jta.build_anchor_set(cfg.anchors, *args),
            pta.build_anchor_set(port_cfg(cfg.anchors), *args))


@pytest.mark.parametrize("match_height,norm", [(False, False), (True, True)])
def test_assign_targets_labels_exact(match_height, norm):
    jset, pset = _anchor_sets()
    for f in dataclasses.fields(jset):
        np.testing.assert_array_equal(getattr(pset, f.name),
                                      getattr(jset, f.name))
    gt, gtc, gtv = _gt(2, 6, 8)
    # a GT on an anchor, so that some anchors pass the matched threshold
    gt[0, 0] = jset.anchors[100]
    gtc[0, 0] = jset.class_ids[100]
    ref = jax.jit(jax.vmap(lambda g, c, v: jta.assign_targets(
        jset, jcod.ResidualCoder(), g, c, v, match_height=match_height,
        norm_by_num_examples=norm)))(gt, gtc, gtv)
    got = pta.assign_targets(pset, pcod.ResidualCoder(), _t(gt), _t(gtc),
                             _t(gtv), match_height=match_height,
                             norm_by_num_examples=norm)
    labels, ref_labels = got[0].numpy(), np.asarray(ref[0])
    assert (ref_labels > 0).sum() >= 2
    # exact, but for an anchor whose IoU with some GT is within float32
    # rounding (1e-6) of that GT's best: the forced match then picks
    # between anchors that tie (the rotated IoU rounds in other orders)
    iou_fn = jb3.boxes_iou3d if match_height else jb3.boxes3d_nearest_bev_iou
    for b, n in zip(*np.nonzero(labels != ref_labels)):
        iou = np.asarray(jax.jit(iou_fn)(jset.anchors, gt[b]))
        cand = (gtc[b][None] == jset.class_ids[:, None]) & gtv[b][None]
        best = np.where(cand, iou, -1).max(0)              # per GT
        assert np.any(cand[n] & (np.abs(iou[n] - best) < 1e-6)
                      & (best > 0)), (b, n, labels[b, n], ref_labels[b, n])
    assert (labels != ref_labels).sum() <= 2
    fg = (labels == ref_labels)[..., None]
    _close(got[1] * _t(fg), np.asarray(ref[1]) * fg, "reg targets")
    _close(got[2] * _t(fg[..., 0]), np.asarray(ref[2]) * fg[..., 0],
           "reg weights")


# ---------------------------------------------------------------------------
# dense heads
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def anchor_head():
    cfg = tiny_voxel_cfg()
    jset, pset = _anchor_sets(cfg)
    hcfg = cfg.head
    bev = np.random.default_rng(9).normal(size=(2, 8, 8, 16)).astype(
        np.float32)
    jmod = jdh.AnchorHeadSingle(hcfg, jset.num_per_loc, 7)
    variables = random_variables(jmod, jnp.asarray(bev), seed=2)
    preds = jax.jit(jmod.apply)(to_jax(variables), jnp.asarray(bev))
    pmod = port_module(pdh.AnchorHeadSingle, 16, port_cfg(hcfg),
                       pset.num_per_loc, 7, variables=variables)
    with torch.no_grad():
        got = pmod(_t(bev).permute(0, 3, 1, 2))
    return dict(cfg=cfg, jset=jset, pset=pset, preds=preds, got=got)


def test_anchor_head_loss_and_decode(anchor_head):
    h = anchor_head
    compare_tree(h["got"], jax.device_get(h["preds"]), "anchor head")
    gt, gtc, gtv = _gt(2, 6, 10)
    gt[:, 0] = h["jset"].anchors[[50, 201]]
    gtc[:, 0] = h["jset"].class_ids[[50, 201]]
    coder = jcod.ResidualCoder()
    hcfg = h["cfg"].head
    for sincos in (False, True):
        jh = dataclasses.replace(hcfg, encode_angle_by_sincos=sincos)
        ref = jax.jit(lambda p: jdh.anchor_head_loss(
            p, h["jset"], coder, jh, gt, gtc, gtv))(h["preds"])
        got = pdh.anchor_head_loss(h["got"], h["pset"], pcod.ResidualCoder(),
                                   port_cfg(jh), _t(gt), _t(gtc), _t(gtv))
        for k in ref:
            _close(got[k], ref[k], f"loss {k}")
    rc, rb = jax.jit(lambda p: jdh.decode_anchor_preds(
        p, h["jset"], coder, hcfg))(h["preds"])
    gc, gb = pdh.decode_anchor_preds(h["got"], h["pset"],
                                     pcod.ResidualCoder(), port_cfg(hcfg))
    _close(gc, rc, "decoded cls")
    _close(gb, rb, "decoded boxes")


def test_center_head_targets_loss_and_decode():
    cfg = tiny_voxel_cfg("CenterPoint")
    ccfg = cfg.center_head
    bev = np.random.default_rng(11).normal(size=(2, 8, 8, 16)).astype(
        np.float32)
    jmod = jdh.CenterHead(ccfg)
    variables = random_variables(jmod, jnp.asarray(bev), seed=3)
    pmod = port_module(pdh.CenterHead, 16, port_cfg(ccfg),
                       variables=variables)
    ref, upd = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(to_jax(variables),
                                                    jnp.asarray(bev))
    got = pmod.train()(_t(bev).permute(0, 3, 1, 2))
    compare_tree(got, jax.device_get(ref), "center head")
    _close(pmod.shared_bn.running_var, upd["batch_stats"]["shared_bn"]["var"],
           "shared_bn var")
    gt, gtc, gtv = _gt(2, 6, 12)
    geo = (cfg.grid_size, cfg.voxel_size, cfg.point_cloud_range)
    rt = jax.jit(jax.vmap(lambda g, c, v: jdh.gaussian_heatmap_targets(
        ccfg, geo[0][:2], geo[1], geo[2], g, c, v)))(gt, gtc, gtv)
    gt_ = pdh.gaussian_heatmap_targets(port_cfg(ccfg), geo[0][:2], geo[1],
                                       geo[2], _t(gt), _t(gtc), _t(gtv))
    for i, name in enumerate(("heatmap", "reg", "inds", "mask")):
        if name in ("inds", "mask"):
            np.testing.assert_array_equal(gt_[i].numpy(), np.asarray(rt[i]))
        else:
            _close(gt_[i], rt[i], name)
    rl = jax.jit(lambda p: jdh.center_head_loss(p, ccfg, *geo, gt, gtc, gtv))(
        ref)
    gl = pdh.center_head_loss(got, port_cfg(ccfg), *geo, _t(gt), _t(gtc),
                              _t(gtv))
    for k in rl:
        _close(gl[k], rl[k], f"center loss {k}")
    rs, rlab, rb = jax.jit(lambda p: jdh.decode_center_preds(
        p, ccfg, *geo, max_boxes=40))(ref)
    gs, glab, gb = pdh.decode_center_preds(got, port_cfg(ccfg), *geo,
                                           max_boxes=40)
    np.testing.assert_array_equal(glab.numpy(), np.asarray(rlab))
    _close(gs, rs, "scores")
    _close(gb, rb, "boxes")


# ---------------------------------------------------------------------------
# post-processing
# ---------------------------------------------------------------------------

def _cands(n=120, c=3, seed=13):
    rng = np.random.default_rng(seed)
    boxes = _gt(1, n, seed)[0][0]
    boxes[:, :2] = boxes[rng.integers(0, 12, n), :2] \
        + rng.normal(0, 0.4, (n, 2))
    # logits with no ties in the max-over-classes scores
    logits = rng.normal(0, 2, (n, c)).astype(np.float32)
    return boxes, logits


@pytest.mark.parametrize("nms_type,thr", [("nms_bev", 0.3),
                                          ("circle_nms", 1.0)])
def test_class_agnostic_and_multi_class_nms(nms_type, thr):
    boxes, logits = _cands()
    jcfg = jpost.NMSConfig(nms_type=nms_type, nms_thresh=thr,
                           nms_pre_maxsize=80, nms_post_maxsize=30,
                           score_thresh=0.2)
    pcfg = port_cfg(jcfg)
    scores = np.asarray(jax.nn.sigmoid(logits)).max(-1)
    valid = np.arange(len(scores)) % 7 != 0
    ri, rs, rv = jax.jit(lambda s, b, v: jpost.class_agnostic_nms(
        s, b, jcfg, v))(scores, boxes, valid)
    gi, gs, gv = ppost.class_agnostic_nms(_t(scores), _t(boxes), pcfg,
                                          _t(valid))
    rv = np.asarray(rv)
    np.testing.assert_array_equal(gv.numpy(), rv)
    np.testing.assert_array_equal(gi.numpy()[rv], np.asarray(ri)[rv])
    _close(gs, rs, "scores")
    assert 3 < rv.sum() <= 30
    probs = np.asarray(jax.nn.sigmoid(logits))
    ref = jax.jit(lambda s, b: jpost.multi_classes_nms(s, b, jcfg))(
        probs, boxes)
    got = ppost.multi_classes_nms(_t(probs), _t(boxes), pcfg)
    v = np.asarray(ref[3])
    np.testing.assert_array_equal(got[3].numpy(), v)
    np.testing.assert_array_equal(got[2].numpy()[v], np.asarray(ref[2])[v])
    _close(got[0][v], np.asarray(ref[0])[v], "boxes")


@pytest.mark.parametrize("mode", ["default", "raw_score", "labels",
                                  "multi_class"])
def test_post_processing(mode):
    boxes, logits = _cands(90, 3, 14)
    bb = np.stack([boxes, _cands(90, 3, 15)[0]])
    ll = np.stack([logits, _cands(90, 3, 15)[1]])
    jcfg = jpost.NMSConfig(nms_pre_maxsize=64, nms_post_maxsize=20,
                           score_thresh=0.1,
                           output_raw_score=mode == "raw_score",
                           multi_classes_nms=mode == "multi_class")
    labels = (np.arange(180).reshape(2, 90) % 3 + 1).astype(np.int32) \
        if mode == "labels" else None
    valid = np.ones((2, 90), bool)
    valid[1, ::5] = False
    ref = jax.jit(lambda c, b: jpost.post_processing(
        c, b, jcfg, valid=valid, labels=labels))(ll, bb)
    got = ppost.post_processing(_t(ll), _t(bb), port_cfg(jcfg),
                                valid=_t(valid),
                                labels=None if labels is None
                                else _t(labels))
    v = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    _close(got["boxes"][_t(v)], np.asarray(ref["boxes"])[v], "boxes")
    _close(got["scores"][_t(v)], np.asarray(ref["scores"])[v], "scores")
    assert v.sum() > 4


def test_generate_recall_record():
    gt, _, gtv = _gt(1, 8, 16)
    pred = gt[0] + np.random.default_rng(17).normal(0, 0.2, gt[0].shape)
    pred = pred.astype(np.float32)
    pv = np.arange(8) % 3 != 2
    ref = jax.jit(lambda p, g: jpost.generate_recall_record(
        p, pv, g, gtv[0], rois=p, roi_valid=pv))(pred, gt[0])
    got = ppost.generate_recall_record(_t(pred), _t(pv), _t(gt[0]),
                                       _t(gtv[0]), rois=_t(pred),
                                       roi_valid=_t(pv))
    assert {k: int(v) for k, v in got.items()} \
        == {k: int(v) for k, v in ref.items()}
