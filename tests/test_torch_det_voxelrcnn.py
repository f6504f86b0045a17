"""The port's VoxelRCNN-Det against the JAX package's at the tiny configs
of tests/test_detection_roi.py (the two-stage half of
tests/test_torch_detectors.py, whose helpers it shares).

The JAX grid pool selects neighbours exactly (the port's selection; its
default is approx_max_k), and dropout is off in the train step. The RoI
sampler draws from another generator than JAX's, so the training
comparison feeds the JAX sampler's output to the port's two-stage path
(the sampler's own invariants: tests/test_torch_det_modules.py). The JAX
run is float64 (tests/test_torch_det_common.py: jax_run says why). Every
leaf is held to 1e-4 of its largest reference value; ``predict``'s valid
sets and labels exactly.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_gar_tpu_torch.convert import load_jax_variables
from tests.test_detection import tiny_voxel_cfg
from tests.test_detection_roi import _tiny_roi_cfg
from tests.test_torch_det_common import (check_train, compare_predict,
                                         compare_tree, det_setup, port_batch,
                                         port_cfg)


def _roi_cfg():
    return dataclasses.replace(_tiny_roi_cfg(), dp_ratio=0.0)


@pytest.fixture(scope="module")
def voxelrcnn():
    import multimodal_gar_tpu.detection.roi_detectors as jax_roi
    from multimodal_gar_tpu_torch.detection.roi_detectors import (
        VoxelRCNNDetector)
    exact = functools.partial(jax_roi.LiDARBackboneConfig,
                              pool_approx_nsample=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_roi, "LiDARBackboneConfig", exact)
        jcfg = tiny_voxel_cfg("SECOND")
        cfg, roi = port_cfg(jcfg), port_cfg(_roi_cfg())
        return det_setup(
            "SECOND", tiny_voxel_cfg, rulebook=True,
            jmodel=jax_roi.VoxelRCNNDetector(jcfg, _roi_cfg()),
            rngs={"sampler": jax.random.PRNGKey(8),
                  "dropout": jax.random.PRNGKey(9)},
            model_fn=lambda: VoxelRCNNDetector(
                cfg, roi, device="cpu",
                generator=torch.Generator().manual_seed(0)))


_SAMPLED = ("rois", "gt_of_rois", "gt_iou_of_rois", "roi_scores",
            "roi_labels", "roi_valid", "reg_valid_mask", "rcnn_cls_labels")


def test_voxelrcnn_eval_and_predict_match_jax(voxelrcnn):
    model = load_jax_variables(voxelrcnn["model_fn"](),
                               voxelrcnn["variables"]).eval()
    with torch.no_grad():
        preds = model(port_batch(voxelrcnn["jb"]))
        out = model.predict(preds)
    ref = voxelrcnn["ref"]
    np.testing.assert_array_equal(preds["roi_valid"].numpy(),
                                  np.asarray(ref["eval_preds"]["roi_valid"]))
    compare_tree(preds, ref["eval_preds"], "VoxelRCNN-Det")
    compare_predict(out, ref["predict"], "VoxelRCNN-Det")
    assert out["valid"].any()


def test_voxelrcnn_train_step_matches_jax(voxelrcnn, monkeypatch):
    import multimodal_gar_tpu_torch.detection.roi_detectors as port_roi
    ref = voxelrcnn["ref"]
    # the float64 reference's sampled RoIs, as the port's float32
    sampled = {k: torch.from_numpy(np.array(
        ref["train_preds"][k], np.float32 if np.issubdtype(
            ref["train_preds"][k].dtype, np.floating) else None))
        for k in _SAMPLED}
    calls = []

    def jax_sampler(generator, cfg, rois, *args):
        """Item i of the JAX sampler's output (items come in order)."""
        i = len(calls) % sampled["rois"].shape[0]
        calls.append(i)
        return {k: v[i] for k, v in sampled.items()}

    monkeypatch.setattr(port_roi, "sample_rois_for_rcnn", jax_sampler)
    check_train(voxelrcnn["model_fn"], voxelrcnn["variables"],
                port_batch(voxelrcnn["jb"]), ref, "VoxelRCNN-Det")
    # two training forwards (gradients, then the step) of every item
    assert len(calls) == 2 * sampled["rois"].shape[0]
