"""The port's detector training at ``DetectorConfig.dtype: bfloat16``
against the JAX package's at bf16: SECOND over the host rulebook's nbr
maps, CenterPoint on the x-window path and VoxelRCNN-Det (which JAX trains
at bf16 too), at the tiny configs of tests/test_detection.py.

Same seeded batch and numpy-drawn weights through the converter; one
jitted JAX value-and-grad per model and dtype, and its bf16 run again on
the batch with 0.1% of the voxel values moved by one bf16 ulp (JAX's own
drift). The rules of tests/test_torch_bf16_train.py's whole train step:
the losses under both bounds (bound 2 where JAX's own drift stays below
half its gap, bound 1 where it stays below bound 1), the new BatchNorm
statistics under bound 1, every gradient finite, each sparse layer's
weight gradient non-zero, and each gradient leaf under bound 1 wherever
JAX's own drift stays below it.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.detection import build_detector as jax_build
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.detection import build_detector
from tests.test_detection import det_batch, tiny_voxel_cfg
from tests.test_torch_bf16 import TOL, _f32, _nudge, _rel, check_bf16
from tests.test_torch_common import random_variables, to_jax
from tests.test_torch_det_common import (expected_tensors, port_batch,
                                         port_cfg, with_rulebook)

ROI_RNGS = {"sampler": jax.random.PRNGKey(8),
            "dropout": jax.random.PRNGKey(9)}


def _models(name):
    """(JAX model at f32, at bf16, the port's model at bf16 on the CPU,
    the JAX rngs)."""
    jcfg = tiny_voxel_cfg("SECOND" if name == "VoxelRCNN-Det" else name)
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg16 = dataclasses.replace(port_cfg(jcfg16),
                                x_window=name == "CenterPoint")
    if name != "VoxelRCNN-Det":
        return (jax_build(name, jcfg), jax_build(name, jcfg16),
                build_detector(name, cfg16, device="cpu"), {}, jcfg)
    import multimodal_gar_tpu.detection.roi_detectors as jax_roi
    from multimodal_gar_tpu_torch.detection.roi_detectors import (
        VoxelRCNNDetector)
    from tests.test_torch_det_voxelrcnn import _roi_cfg
    exact = functools.partial(jax_roi.LiDARBackboneConfig,
                              pool_approx_nsample=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_roi, "LiDARBackboneConfig", exact)
        models = (jax_roi.VoxelRCNNDetector(jcfg, _roi_cfg()),
                  jax_roi.VoxelRCNNDetector(jcfg16, _roi_cfg()))
    port = VoxelRCNNDetector(cfg16, port_cfg(_roi_cfg()), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return models + (port, ROI_RNGS, jcfg)


@functools.lru_cache(maxsize=None)
def _runs(name):
    j32, j16, port, rngs, jcfg = _models(name)
    jb = with_rulebook(det_batch(jcfg, batch_size=2, seed=3,
                                 m=jcfg.max_voxels_per_stage[0]), jcfg)
    variables = random_variables(j32, jb, train=False, seed=1)
    jv = to_jax(variables)

    def step_of(jm):
        def loss_fn(params, batch):
            preds, upd = jm.apply(
                {"params": params, "batch_stats": jv["batch_stats"]}, batch,
                train=True, mutable=["batch_stats"], rngs=rngs)
            losses = jm.loss(preds, batch)
            return losses["loss"], (losses, upd["batch_stats"])
        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    model = load_jax_variables(port, variables).train()
    runs = {}
    step16 = step_of(j16)
    nudged = jb.replace(voxels=_nudge(np.asarray(jb.voxels), 2))
    for key, step, batch in (("ref16", step16, jb), ("drift", step16, nudged),
                             ("ref32", step_of(j32), jb)):
        (_, (losses, stats)), grads = step(jv["params"], batch)
        want = expected_tensors(model, jax.device_get(grads),
                                jax.device_get(stats))
        runs[key] = dict(
            losses={k: np.asarray(v) for k, v in losses.items()},
            stats={k: v for k, v in want.items()
                   if k in dict(model.named_buffers())},
            grads={k: v for k, v in want.items()
                   if k in dict(model.named_parameters())})
    batch = port_batch(jb)
    losses = model.loss(model(batch), batch)
    losses["loss"].backward()
    runs["got"] = dict(
        losses={k: v.detach() for k, v in losses.items()},
        stats=dict(model.named_buffers()),
        grads={k: p.grad if p.grad is not None else torch.zeros_like(p)
               for k, p in model.named_parameters()})
    return runs


@pytest.mark.parametrize("name", ["SECOND", "CenterPoint",
                                  "VoxelRCNN-Det"])
def test_detector_train_step_matches_jax_bf16(name):
    r = _runs(name)
    got = r["got"]
    for key, ref in r["ref16"]["losses"].items():
        drift = _rel(r["drift"]["losses"][key], ref)
        if drift <= TOL:
            check_bf16(got["losses"][key], ref, r["ref32"]["losses"][key],
                       f"{name} {key}", drift)
    for key, ref in r["ref16"]["stats"].items():
        assert _rel(_f32(got["stats"][key]), _f32(ref)) <= TOL, key
    assert set(got["grads"]) == set(r["ref16"]["grads"])
    drifting = []
    for key, ref in r["ref16"]["grads"].items():
        g = _f32(got["grads"][key])
        assert np.all(np.isfinite(g)), key
        drift = _rel(_f32(r["drift"]["grads"][key]), _f32(ref))
        if drift > TOL:
            drifting.append(key)
            continue
        assert _rel(g, _f32(ref)) <= TOL, (key, _rel(g, _f32(ref)), drift)
    sparse = [k for k in got["grads"]
              if "backbone_3d." in k and k.endswith(".conv.weight")]
    assert len(sparse) == 11
    for key in sparse:
        assert torch.count_nonzero(got["grads"][key]) > 0, key
    print(f"{name}: {len(drifting)} of {len(got['grads'])} leaves past "
          f"bound 1 in JAX's own drift: {drifting}")
