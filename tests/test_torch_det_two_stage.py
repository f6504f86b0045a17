"""The port's PV-RCNN, SECONDNetIoU, PartA2 and PointRCNN against the JAX
package's at tiny configs (those of tests/test_detection_roi.py,
test_detection_sparse.py and test_detection_point.py), with the helpers of
tests/test_torch_det_common.py: one float64 JAX run per model (jax_run
says why), every leaf to 1e-4 of its largest reference value, ``predict``'s
valid sets and labels exactly. Dropout is off; the training comparison
feeds the JAX sampler's RoIs to the port's two-stage path.

PV-RCNN runs at batch 1: the JAX package calls its SA modules under
``jax.vmap``, whose BatchNorms leak their running statistics in training
(ROADMAP Queue 3); at batch 1 that vmap is one call and the port's
batch-wide statistics are the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_detection import det_batch, tiny_voxel_cfg
from tests.test_detection_roi import _tiny_roi_cfg
from tests.test_torch_det_common import (check_eval,
                                         check_train_with_jax_sampler,
                                         family_setup, port_cfg, with_points,
                                         with_rulebook)

CPU = dict(device="cpu")


def _gen():
    return torch.Generator().manual_seed(0)


def _roi_cfg(**kw):
    return dataclasses.replace(_tiny_roi_cfg(), dp_ratio=0.0, **kw)


@pytest.fixture(scope="module")
def pvrcnn():
    import multimodal_gar_tpu.detection.pfe as jax_pfe
    import multimodal_gar_tpu.detection.roi_detectors as jax_roi
    from multimodal_gar_tpu.detection.pfe import SALayerConfig, VSAConfig
    from multimodal_gar_tpu_torch.detection import pfe as port_pfe
    from multimodal_gar_tpu_torch.detection.roi_detectors import (
        PVRCNNDetector)
    jcfg = tiny_voxel_cfg("SECOND")
    vsa = VSAConfig(num_keypoints=48, num_output_features=16, sa_layers=(
        SALayerConfig("raw_points", 1, (0.8, 1.6), (8, 4),
                      ((8, 8), (8,))),
        SALayerConfig("x_conv2", 2, (1.6,), (8,), ((8,),)),
        SALayerConfig("x_conv4", 8, (3.2,), (4,), ((8,),))),
        use_bev=True, bev_stride=8)
    roi = _roi_cfg(pool_radii=(0.8, 1.6), pool_nsamples=(8, 4),
                   pool_mlps=((8,), (8,)))
    jb = with_points(det_batch(jcfg, batch_size=1, seed=3, m=96), jcfg,
                     160, seed=11, invalid=20)
    cfg, proi = port_cfg(jcfg), port_cfg(roi)
    pvsa = port_pfe.VSAConfig(
        vsa.num_keypoints, vsa.num_output_features,
        tuple(port_pfe.SALayerConfig(*dataclasses.astuple(s))
              for s in vsa.sa_layers), vsa.use_bev, vsa.bev_stride)
    return family_setup(
        jax_roi.PVRCNNDetector(jcfg, roi, vsa), jb,
        lambda: PVRCNNDetector(cfg, proi, pvsa, generator=_gen(), **CPU),
        item_zero_modules=(jax_pfe, jax_roi))


def test_pvrcnn_eval_and_predict_match_jax(pvrcnn):
    preds = check_eval(pvrcnn, "PV-RCNN")
    # the keypoints are the JAX FPS's points, exactly
    np.testing.assert_array_equal(
        preds["keypoints"].numpy(),
        np.asarray(pvrcnn["ref"]["eval_preds"]["keypoints"], np.float32))


def test_pvrcnn_train_step_matches_jax(pvrcnn, monkeypatch):
    check_train_with_jax_sampler(pvrcnn, "PV-RCNN", monkeypatch)


@pytest.fixture(scope="module")
def second_iou():
    import multimodal_gar_tpu.detection.roi_detectors as jax_roi
    from multimodal_gar_tpu_torch.detection.roi_detectors import (
        SECONDIoUDetector)
    jcfg = tiny_voxel_cfg("SECOND")
    roi = _roi_cfg(use_corner_loss=False)
    jb = with_rulebook(det_batch(jcfg, batch_size=2, seed=3,
                                 m=jcfg.max_voxels_per_stage[0]), jcfg)
    cfg, proi = port_cfg(jcfg), port_cfg(roi)
    return family_setup(
        jax_roi.SECONDIoUDetector(jcfg, roi), jb,
        lambda: SECONDIoUDetector(cfg, proi, generator=_gen(), **CPU))


def test_second_iou_eval_and_predict_match_jax(second_iou):
    check_eval(second_iou, "SECONDNetIoU")


def test_second_iou_train_step_matches_jax(second_iou, monkeypatch):
    check_train_with_jax_sampler(second_iou, "SECONDNetIoU", monkeypatch)


def _parta2_jax_model(jcfg):
    import multimodal_gar_tpu.detection.parta2 as jax_parta2
    return jax_parta2.PartA2Detector(
        jcfg, _roi_cfg(), jax_parta2.PartA2Config(
            pool_size=4, part_conv_channels=(8,), seg_conv_channels=(8, 8)))


@pytest.fixture(scope="module")
def parta2():
    from multimodal_gar_tpu_torch.detection.parta2 import (PartA2Config,
                                                           PartA2Detector)
    jcfg = tiny_voxel_cfg("SECOND")
    # the host rulebook: the encoder on its nbr maps, the decoder's inverse
    # convs on the rulebook's down maps
    jb = with_rulebook(det_batch(jcfg, batch_size=2, seed=3,
                                 m=jcfg.max_voxels_per_stage[0]), jcfg)
    cfg, proi = port_cfg(jcfg), port_cfg(_roi_cfg())
    part = PartA2Config(pool_size=4, part_conv_channels=(8,),
                        seg_conv_channels=(8, 8))
    setup = family_setup(
        _parta2_jax_model(jcfg), jb,
        lambda: PartA2Detector(cfg, proi, part, generator=_gen(), **CPU))
    setup["x_window_fn"] = lambda: PartA2Detector(
        dataclasses.replace(cfg, x_window=True), proi, part,
        generator=_gen(), **CPU)
    return setup


def test_parta2_eval_and_predict_match_jax(parta2):
    check_eval(parta2, "PartA2")


def test_parta2_train_step_matches_jax(parta2, monkeypatch):
    import multimodal_gar_tpu_torch.ops.boxes3d as port_boxes
    pooled = []
    real = port_boxes.roiaware_pool3d

    def record(points, features, boxes, out_size, pool_method):
        out = real(points, features, boxes, out_size, pool_method)
        pooled.append((points, features.detach(), boxes, out_size,
                       pool_method))
        return out

    monkeypatch.setattr(port_boxes, "roiaware_pool3d", record)
    check_train_with_jax_sampler(parta2, "PartA2", monkeypatch)
    monkeypatch.setattr(port_boxes, "roiaware_pool3d", real)
    # the seg branch differentiates through the max: no cell of the
    # compared steps holds two equal maxima
    assert any(method == "max" for *_, method in pooled)
    for points, feats, boxes, g, method in pooled:
        if method == "max":
            assert_no_ties_in_cells(points, feats, boxes, g)


def test_parta2_x_window_encoder_matches_jax(parta2, monkeypatch):
    """With ``x_window`` the UNetV2 encoder runs the x-window kernel (its
    plain version here) over the rulebook's window maps and the decoder
    follows in the key-sorted row order: the training losses, gradients,
    statistics and the step are the JAX run's (no loss sees the order)."""
    check_train_with_jax_sampler(dict(parta2, model_fn=parta2["x_window_fn"]),
                                 "PartA2 x-window", monkeypatch)


def assert_no_ties_in_cells(points, feats, boxes, g):
    """No channel of any RoI-aware max cell has two points at its max."""
    import multimodal_gar_tpu_torch.ops.boxes3d as port_boxes
    for b in range(boxes.shape[0]):
        for n in range(boxes.shape[1]):
            one = port_boxes.roiaware_pool3d(points[b:b + 1], feats[b:b + 1],
                                             boxes[b:b + 1, n:n + 1], g,
                                             "max")[0, 0].reshape(-1,
                                                                  feats.shape[-1])
            inside = port_boxes.points_in_boxes(points[b], boxes[b, n:n + 1]
                                                )[:, 0]
            hits = (feats[b][inside][None] == one[:, None, :]) \
                & (one[:, None, :] != 0)
            assert int(hits.sum(1).max()) <= 1


@pytest.fixture(scope="module")
def pointrcnn():
    from multimodal_gar_tpu.detection.point_rcnn import (
        PointRCNNDetector as JaxPointRCNN, PointRCNNRoIConfig as JaxPool)
    from multimodal_gar_tpu.detection.pointnet2 import (
        PointNet2Config as JaxPN2)
    from multimodal_gar_tpu_torch.detection.point_rcnn import (
        PointRCNNDetector, PointRCNNRoIConfig)
    from multimodal_gar_tpu_torch.detection.pointnet2 import PointNet2Config
    jcfg = tiny_voxel_cfg("SECOND")
    pn2 = dict(npoints=(48, 16), radii=((0.8, 1.6), (2.0,)),
               nsamples=((8, 4), (8,)), sa_mlps=(((8, 8), (8,)), ((16,),)),
               fp_mlps=((16,), (16,)))
    pool = dict(num_sampled_points=24, xyz_up_layer=(8,),
                sa_npoints=(8, -1), sa_radii=(0.8, 100.0),
                sa_nsamples=(4, 4), sa_mlps=((8,), (8, 16)))
    roi = _roi_cfg()
    jb = with_points(det_batch(jcfg, batch_size=2, seed=3, m=48), jcfg, 120,
                     seed=5, invalid=16)
    cfg, proi = port_cfg(jcfg), port_cfg(roi)
    return family_setup(
        JaxPointRCNN(jcfg, roi, JaxPN2(**pn2), JaxPool(**pool)), jb,
        lambda: PointRCNNDetector(cfg, proi, PointNet2Config(**pn2),
                                  PointRCNNRoIConfig(**pool),
                                  generator=_gen(), **CPU))


def test_pointrcnn_eval_and_predict_match_jax(pointrcnn):
    check_eval(pointrcnn, "PointRCNN")


def test_pointrcnn_train_step_matches_jax(pointrcnn, monkeypatch):
    check_train_with_jax_sampler(pointrcnn, "PointRCNN", monkeypatch)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_inverse_conv_maps_equal_jax_lookup(stage):
    """The port's inverse-conv map (the strided layer's inverse map) equals
    the gather of the JAX package's own SparseInverseConv3d, which builds
    its own lookup of the coarse set, exactly: an identity kernel per tap
    over coarse features holding each row's number reads its map. The
    coarse stage's cap cuts sites off."""
    from multimodal_gar_tpu.detection.sparse_backbones import (
        SparseInverseConv3d)
    from multimodal_gar_tpu.models.sparse_backbone import SparseTensor as JST
    from multimodal_gar_tpu_torch.data.rulebook import STAGE_PADDINGS
    from multimodal_gar_tpu_torch.ops.device_rulebook import (
        conv_out_shape, device_rulebook)
    from multimodal_gar_tpu_torch.ops.sparse_maps import (backbone_maps,
                                                          inverse_conv_maps)
    rng = np.random.default_rng(stage)
    shape0 = (21, 48, 48)
    keys = np.stack([rng.choice(np.prod(shape0), 900, replace=False)
                     for _ in range(2)])                  # unique voxels
    coords = np.stack(np.unravel_index(keys, shape0), -1).astype(np.int32)
    caps = (900, 500, 240, 20)
    rb = device_rulebook(torch.from_numpy(coords),
                         torch.ones((2, 900), dtype=torch.bool), shape0, caps)
    assert int(rb[f"dropped_{stage}"].sum()) > 0
    inv = inverse_conv_maps(backbone_maps(rb, False)[f"down_{stage}"])
    shapes = [shape0]
    for k in (1, 2, 3):
        shapes.append(conv_out_shape(shapes[-1], 3, 2, STAGE_PADDINGS[k]))

    def stage_set(k):
        if k == 0:
            return coords, np.ones((2, 900), bool)
        c = rb[f"coords_{k}"].numpy()
        return c, np.arange(c.shape[1])[None] < rb[f"count_{k}"].numpy()[:, None]
    fc, fv = stage_set(stage - 1)
    cc, cv = stage_set(stage)
    rows = (np.arange(cc.shape[1], dtype=np.float64)[None, :, None] + 1) \
        * np.ones((2, 1, 1))
    coarse = JST(jnp.asarray(rows), jnp.asarray(cc), jnp.asarray(cv),
                 shapes[stage])
    mod = SparseInverseConv3d(27, padding=STAGE_PADDINGS[stage])
    kernel = np.zeros((27, 1, 27))
    kernel[np.arange(27), 0, np.arange(27)] = 1.0
    with jax.enable_x64(True):
        out = mod.apply({"params": {"kernel": jnp.asarray(kernel)}}, coarse,
                        jnp.asarray(fc), jnp.asarray(fv), shapes[stage - 1])
        jax_map = np.asarray(out.features).round().astype(np.int64) - 1
    got = inv.fwd.numpy()
    np.testing.assert_array_equal(got[fv], jax_map[fv])
    assert (got[~fv] == -1).all()
    assert (got >= 0).sum() > 0
