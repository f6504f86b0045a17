"""The slice as a whole: a nuScenes tree through the port's dataset adapter
and registry into a 5-feature CenterPoint, against the JAX package.

The tree is utils/testing.py: write_nuscenes_tree at the JAX tests' size
(two frames of 400 points, one sweep each) over the tiny config's range.
Its DetBatch (5 features: the time lag in the fifth) equals the JAX
package's leaf for leaf. CenterPoint at ``nuscenes_centerpoint_config(
tiny=True)`` (the ten nuScenes classes) is built through the detector
registry for 5 features, the JAX model's numpy-drawn weights converted
through convert.py, and its forward, ``predict``, the training losses,
every gradient and new BatchNorm statistic and one AdamW step are held to
the float64 JAX run at 1e-4 (tests/test_torch_det_common.py: jax_run).
``models.build_model`` builds SECOND for the config's 5 point features, its
eval forward and ``predict`` held to the JAX package's ``build_model``; the
NDS evaluation of the port's predictions equals the JAX package's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_gar_tpu.config as jax_config
import multimodal_gar_tpu.data.nuscenes as jax_nuscenes
import multimodal_gar_tpu.detection.dense_heads as jax_heads
import multimodal_gar_tpu.detection.detectors as jax_det
import multimodal_gar_tpu.detection.post as jax_post
from multimodal_gar_tpu.detection import build_detector as jax_build
from multimodal_gar_tpu.models.registry import build_model as jax_build_model
import multimodal_gar_tpu_torch.data.registry as port_registry
from multimodal_gar_tpu_torch.config import Config
from multimodal_gar_tpu_torch.detection import build_detector
from multimodal_gar_tpu_torch.models import build_model
from multimodal_gar_tpu_torch.utils.testing import (
    TINY_NUSCENES_RANGE, TINY_NUSCENES_TREE, TINY_NUSCENES_VOXEL,
    nuscenes_centerpoint_config, write_nuscenes_tree)
from tests.test_torch_common import random_variables, to_jax
from tests.test_torch_dataset_registry import same_batches
from tests.test_torch_det_common import (check_eval, check_train,
                                         compare_predict, compare_tree)

_JAX_CLASSES = {cls.__name__: cls for cls in (
    jax_det.DetectorConfig, jax_heads.CenterHeadConfig,
    jax_heads.AnchorHeadConfig, jax_post.NMSConfig)}


def jax_cfg(obj):
    """A port config dataclass (nested) as the JAX package's class of the
    same name, field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _JAX_CLASSES.get(type(obj).__name__)
        if cls is None:
            import multimodal_gar_tpu.detection.anchors as jax_anchors
            cls = getattr(jax_anchors, type(obj).__name__)
        return cls(**{f.name: jax_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(jax_cfg(v) for v in obj)
    return obj


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    info = write_nuscenes_tree(
        str(root), point_cloud_range=TINY_NUSCENES_RANGE, **TINY_NUSCENES_TREE)
    kwargs = dict(root=str(root), info_paths=[info], max_sweeps=2,
                  point_cloud_range=TINY_NUSCENES_RANGE)
    jds = jax_nuscenes.NuScenesDataset(**kwargs)
    jb = jds.det_batch([0, 1], TINY_NUSCENES_VOXEL, 256)
    pds = port_registry.build_dataset("NuScenesDataset", **kwargs)
    (idx, batch), = port_registry.det_batches(
        pds, 2, TINY_NUSCENES_VOXEL, 256, shuffle=False, with_indices=True,
        device="cpu")
    return dict(kwargs=kwargs, jb=jb, batch=batch, idx=idx, dataset=pds)


@pytest.fixture(scope="module")
def centerpoint(tree):
    from tests.test_torch_det_common import jax_run
    cfg = nuscenes_centerpoint_config(tiny=True)
    jmodel = jax_build("CenterPoint", jax_cfg(cfg))
    variables = random_variables(jmodel, tree["jb"], train=False, seed=1)
    return dict(jb=tree["jb"], variables=variables,
                ref=jax_run(jmodel, to_jax(variables), tree["jb"]),
                model_fn=lambda: build_detector(
                    "CenterPoint", cfg, in_channels=5, device="cpu"))


def test_nuscenes_batch_through_the_registry_is_the_jax_batch(tree):
    batch = tree["batch"]
    assert tree["idx"] == [0, 1]
    assert batch.voxels.shape[-1] == 5
    # the sweep's points carry the time lag in the fifth feature
    lags = batch.voxels[..., 4][batch.voxel_valid]
    assert float(lags.max()) == pytest.approx(0.05)
    same_batches(batch, tree["jb"])


def test_centerpoint_at_5_features_matches_jax(tree, centerpoint):
    model = centerpoint["model_fn"]()
    weight = model.trunk.backbone_3d.conv_input.conv.weight
    assert weight.shape[:2] == (27, 5)
    preds = check_eval(centerpoint, "nuScenes CenterPoint")
    assert preds["hm"].shape[-1] == 10
    check_train(centerpoint["model_fn"], centerpoint["variables"],
                tree["batch"], centerpoint["ref"], "nuScenes CenterPoint")


def test_nds_of_the_predictions_matches_jax(tree, centerpoint):
    """The port's ``predict`` on its own forward, scored by the port's
    NuScenesDataset.evaluation, against the JAX predictions scored by the
    JAX package's, every metric to 1e-6 of its value."""
    from multimodal_gar_tpu_torch.convert import load_jax_variables
    model = load_jax_variables(centerpoint["model_fn"](),
                               centerpoint["variables"]).eval()
    with torch.no_grad():
        out = model.predict(model(tree["batch"]))
    ref = centerpoint["ref"]["predict"]

    def annos(boxes, scores, labels, valid, names):
        return [{"token": info["token"], "boxes_lidar": np.asarray(
            boxes[i])[np.asarray(valid[i])], "score": np.asarray(
            scores[i])[np.asarray(valid[i])], "name": [
            names[c - 1] for c in np.asarray(labels[i])[np.asarray(
                valid[i])]]} for i, info in enumerate(
            tree["dataset"].infos)]
    names = tree["dataset"].class_names
    got = tree["dataset"].evaluation(annos(
        out["boxes"].numpy(), out["scores"].numpy(), out["labels"].numpy(),
        out["valid"].numpy(), names))
    jds = jax_nuscenes.NuScenesDataset(**tree["kwargs"])
    want = jds.evaluation(annos(ref["boxes"], ref["scores"], ref["labels"],
                                ref["valid"], names))
    assert sum(int(v.sum()) for v in out["valid"]) > 0

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", float(v)
    got, want = dict(flat(got)), dict(flat(want))
    assert got.keys() == want.keys()
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or got[k] == \
            pytest.approx(want[k], rel=1e-6, abs=1e-9), k


def _config(cls, width: int):
    cfg = cls()
    pc = dataclasses.replace(
        cfg.data.point_cloud, range=TINY_NUSCENES_RANGE,
        num_point_features=width,
        voxel=dataclasses.replace(cfg.data.point_cloud.voxel,
                                  voxel_size=TINY_NUSCENES_VOXEL))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, point_cloud=pc))


def test_build_model_second_at_5_features_matches_jax(tree):
    """build_model (the model registry) at the config's 5 point features:
    the port's SECOND against the JAX package's build_model on the same
    5-feature nuScenes batch, eval forward and predict (its KITTI head
    scores three classes, so the GT takes no part)."""
    from tests.test_torch_det_common import jax_run
    jb = tree["jb"]
    jb = jb.replace(gt_classes=jnp.minimum(jb.gt_classes, 3))
    jmodel = jax_build_model(_config(jax_config.Config, 5), "SECOND")
    variables = random_variables(jmodel, jb, train=False, seed=2)
    ref = jax_run(jmodel, to_jax(variables), jb)
    model = build_model(_config(Config, 5), "SECOND", device="cpu")
    from multimodal_gar_tpu_torch.convert import load_jax_variables
    model = load_jax_variables(model, variables).eval()
    assert model.trunk.backbone_3d.conv_input.conv.weight.shape[1] == 5
    with torch.no_grad():
        preds = model(tree["batch"])
        out = model.predict(preds)
    compare_tree(preds, ref["eval_preds"], "SECOND at 5 features")
    compare_predict(out, ref["predict"], "SECOND at 5 features")
