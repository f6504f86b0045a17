"""The port's single-stage detectors (SECOND, PointPillar, CenterPoint)
against the JAX package's, at the tiny configs of tests/test_detection.py,
and the registry's detector names (VoxelRCNN-Det:
tests/test_torch_det_voxelrcnn.py).

Same seeded batch, the JAX model's weights drawn with numpy
(tests/test_torch_common.py: random_variables) and carried through the
converter. Each model is run once in JAX per file, in float64
(tests/test_torch_det_common.py: jax_run, one jit). Held to 1e-4 of the largest reference value: the eval
outputs, the training losses, every gradient and new BatchNorm statistic,
and the weights and Adam moments after one clipped AdamW step at lr 1e-6;
``predict``'s valid sets and labels exactly. SECOND runs with the host
rulebook (nbr maps and K3's plain version) and without it (maps built by
ops/device_rulebook.py), and on the x-window path.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodal_gar_tpu_torch.config import Config
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.models import build_model
from multimodal_gar_tpu_torch.models.registry import DETECTOR_NAMES
from tests.test_detection import tiny_pillar_cfg, tiny_voxel_cfg
from tests.test_torch_common import assert_close, random_variables, to_jax
from tests.test_torch_det_common import (check_train, compare_predict,
                                         compare_tree, det_setup, port_batch)


@pytest.fixture(scope="module")
def second():
    return det_setup("SECOND", tiny_voxel_cfg, rulebook=True)


@pytest.fixture(scope="module")
def pillar():
    return det_setup("PointPillar", tiny_pillar_cfg, rulebook=False)


@pytest.fixture(scope="module")
def pillarnet():
    # PillarNet's deeper pillar trunk: two PFN layers (the tiny pillar
    # config has one)
    return det_setup("PillarNet", lambda name: dataclasses.replace(
        tiny_pillar_cfg(name), pillar_filters=(8, 16)), rulebook=False)


@pytest.fixture(scope="module")
def centerpoint():
    return det_setup("CenterPoint", tiny_voxel_cfg, rulebook=True)


def _eval(run, batch, **over):
    model = load_jax_variables(run["model_fn"](**over), run["variables"])
    with torch.no_grad():
        preds = model.eval()(batch)
        out = model.predict(preds)
    return preds, out

@pytest.mark.parametrize("path", ["nbr", "no_rulebook", "x_window"])
def test_second_eval_and_predict_match_jax(second, path):
    batch = port_batch(second["jb"], with_rulebook=path != "no_rulebook")
    preds, out = _eval(second, batch, x_window=path == "x_window")
    ref = second["ref"]
    compare_tree(preds, ref["eval_preds"], f"SECOND {path}")
    compare_predict(out, ref["predict"], f"SECOND {path}")
    assert out["valid"].any()


def test_second_train_step_matches_jax(second):
    check_train(second["model_fn"], second["variables"],
                port_batch(second["jb"]), second["ref"], "SECOND")


def test_second_train_step_without_rulebook(second):
    check_train(second["model_fn"], second["variables"],
                port_batch(second["jb"], with_rulebook=False), second["ref"],
                "SECOND, no rulebook")


@pytest.mark.parametrize("which", ["pillar", "pillarnet"])
def test_pillar_detectors_match_jax(which, request):
    run = request.getfixturevalue(which)
    batch = port_batch(run["jb"])
    preds, out = _eval(run, batch)
    compare_tree(preds, run["ref"]["eval_preds"], which)
    compare_predict(out, run["ref"]["predict"], which)
    check_train(run["model_fn"], run["variables"], batch, run["ref"], which)


@pytest.mark.parametrize("name", ["SECOND", "SECONDNet", "PointPillar",
                                  "PillarNet", "CenterPoint",
                                  "VoxelRCNN-Det", "PVRCNN", "PV-RCNN",
                                  "SECONDNetIoU", "PartA2", "PartA2Net",
                                  "PointRCNN", "VoxelNeXt", "PVRCNNPlusPlus",
                                  "PV-RCNN++", "CaDDN", "MPPNet",
                                  "MPPNetE2E"])
def test_build_model_threads_the_geometry(name):
    cfg = Config()
    pc = dataclasses.replace(
        cfg.data.point_cloud, range=(0.0, -8.0, -2.0, 16.0, 8.0, 2.0),
        voxel=dataclasses.replace(cfg.data.point_cloud.voxel,
                                  voxel_size=(0.5, 0.5, 4.0) if "Pillar"
                                  in name else (0.25, 0.25, 0.125)))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, point_cloud=pc))
    model = build_model(cfg, name, device="cpu")
    assert model.cfg.point_cloud_range == tuple(pc.range)
    assert model.cfg.voxel_size == tuple(pc.voxel.voxel_size)
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert name in DETECTOR_NAMES


def test_unported_detector_names_still_raise():
    """No name of the JAX package's zoo is left unported: every one of
    DETECTOR_NAMES builds through the zoo's registry, and none raises."""
    from multimodal_gar_tpu_torch.detection import available_detectors
    assert set(DETECTOR_NAMES) == set(available_detectors())
    assert len(DETECTOR_NAMES) == 18


def test_centerpoint_matches_jax(centerpoint):
    batch = port_batch(centerpoint["jb"])
    preds, out = _eval(centerpoint, batch)
    compare_tree(preds, centerpoint["ref"]["eval_preds"], "CenterPoint")
    compare_predict(out, centerpoint["ref"]["predict"], "CenterPoint")
    check_train(centerpoint["model_fn"], centerpoint["variables"], batch,
                centerpoint["ref"], "CenterPoint")


@pytest.mark.parametrize("kernel,stride,padding,cap", [
    ((3, 1, 1), (2, 1, 1), 0, 400),     # conv_out, every site kept
    ((3, 1, 1), (2, 1, 1), 0, 60),      # conv_out past its cap
    (3, 2, (0, 1, 1), 50)])             # conv4_down's geometry, capped
def test_strided_sparse_conv_maps_exact(kernel, stride, padding, cap):
    """The generalised active set and gather map against the JAX
    package's SparseConv3dDown without a rulebook: output sites (the
    smallest keys past the cap), their count cut off, and the features."""
    from multimodal_gar_tpu.models.sparse_backbone import (
        SparseConv3dDown as JaxDown, SparseTensor as JaxST,
        _downsample_active_set)
    from multimodal_gar_tpu_torch.models.sparse_backbone import (
        SparseConv3dDown, SparseTensor)
    from multimodal_gar_tpu_torch.ops.device_rulebook import conv_out_shape
    from tests.test_torch_common import port_module
    shape, m = (9, 12, 10), 160
    rng = np.random.default_rng(5)
    keys = np.stack([rng.choice(np.prod(shape), m, replace=False)
                     for _ in range(2)])
    coords = np.stack(np.unravel_index(keys, shape), -1).astype(np.int32)
    valid = np.ones((2, m), bool)
    valid[1, 120:] = False
    coords[~valid] = -1
    feats = rng.normal(size=(2, m, 8)).astype(np.float32) * valid[..., None]
    jst = JaxST(jax.numpy.asarray(feats), jax.numpy.asarray(coords),
                jax.numpy.asarray(valid), shape)
    jmod = JaxDown(16, kernel_size=kernel, stride=stride, padding=padding,
                   max_out_voxels=cap)
    variables = random_variables(jmod, jst, seed=4)
    ref = jax.jit(jmod.apply)(to_jax(variables), jst)
    out_shape = conv_out_shape(shape, kernel, stride, padding)
    _, _, dropped = jax.jit(_downsample_active_set, static_argnums=(
        2, 3, 4, 5, 6, 7))(jst.coords, jst.valid, shape, out_shape, kernel,
                           stride, padding, cap)
    pmod = port_module(SparseConv3dDown, 8, 16, kernel, stride, padding,
                       cap, variables=variables)
    got = pmod(SparseTensor(torch.from_numpy(feats),
                            torch.from_numpy(coords),
                            torch.from_numpy(valid), shape))
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), rv)
    # padded rows: -1 in the port, 0 in the JAX package (both unread)
    np.testing.assert_array_equal(
        got.coords.numpy(), np.where(rv[..., None], np.asarray(ref.coords),
                                     -1))
    np.testing.assert_array_equal(pmod.dropped_sites.numpy(),
                                  np.asarray(dropped))
    assert got.spatial_shape == tuple(ref.spatial_shape)
    assert_close(got.features.detach().numpy(), np.asarray(ref.features),
                 1e-4, "features")
    assert (np.asarray(dropped) > 0).any() == (cap < 100)
