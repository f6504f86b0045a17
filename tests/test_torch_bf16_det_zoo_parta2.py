"""PartA2 at ``DetectorConfig.dtype: bfloat16`` against the JAX package's
at bf16, at the tiny config of tests/test_torch_det_two_stage.py: the eval
forward, ``predict``, and one b2 train step fed the JAX sampler's RoIs.
tests/test_torch_bf16_det_zoo_next.py holds VoxelNeXt and the other
two-stage families by the same rules and helpers.

Same seeded batch and numpy-drawn weights through the converter; one
jitted JAX bf16 run per model, and again on the batch with 0.1% of the
voxel values moved by one bf16 ulp (JAX's own drift). Bound 2's float32
side is the port's own float32 model on the same weights and batch (RoIs
included), which tests/test_torch_det_two_stage.py and
tests/test_torch_det_next.py hold to JAX's to 1e-4 of the largest value,
a tenth of the smallest gap bound 2 reads (1e-3): it spares a second JAX
trace of each model. The
rules of tests/test_torch_bf16_det_train.py: the eval outputs and the
losses under both bounds (bound 2 where JAX's own drift stays below half
its gap, bound 1 where it stays below bound 1), the new BatchNorm
statistics and each gradient leaf under bound 1 wherever JAX's own drift
stays below it, every gradient finite and each sparse layer's weight
gradient non-zero. Integer outputs (active sets, RoI labels, ``predict``'s
valid sets and labels) are equal wherever JAX's drift run keeps them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu_torch.convert import load_jax_variables
from tests.test_detection import det_batch, tiny_voxel_cfg
from tests.test_torch_bf16 import TOL, _f32, _nudge, _rel, check_bf16
from tests.test_torch_common import random_variables, to_jax
from tests.test_torch_det_common import (SAMPLED, SAMPLER_RNGS, _ItemZeroJax,
                                         expected_tensors, port_batch,
                                         port_cfg, with_points,
                                         with_rulebook)

CPU = dict(device="cpu")


def _models(name):
    """(JAX model at the bf16 config, the port's model at a dtype, the
    float32 config, batch)."""
    jcfg = tiny_voxel_cfg("SECOND")
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    gen = dict(generator=torch.Generator().manual_seed(0), **CPU)
    if name == "PartA2":
        from multimodal_gar_tpu_torch.detection.parta2 import (
            PartA2Config, PartA2Detector)
        from tests.test_torch_det_two_stage import (_parta2_jax_model,
                                                    _roi_cfg)
        jb = with_rulebook(det_batch(jcfg, batch_size=2, seed=3,
                                     m=jcfg.max_voxels_per_stage[0]), jcfg)
        return _parta2_jax_model(jcfg16), lambda c: PartA2Detector(
            port_cfg(c), port_cfg(_roi_cfg()),
            PartA2Config(pool_size=4, part_conv_channels=(8,),
                         seg_conv_channels=(8, 8)), **gen), jcfg, jb
    import multimodal_gar_tpu.detection.voxelnext as jax_vn
    import multimodal_gar_tpu_torch.detection.voxelnext as port_vn
    from tests.test_torch_det_next import _vn_cfg
    return (jax_vn.VoxelNeXtDetector(jcfg16, _vn_cfg(jax_vn)),
            lambda c: port_vn.VoxelNeXtDetector(port_cfg(c),
                                                _vn_cfg(port_vn), **gen),
            jcfg, det_batch(jcfg, batch_size=2, seed=3, m=96))


def _jax_fn(model):
    """One jit: eval predictions and ``predict``, the training
    predictions, losses, gradients and new statistics."""
    def run(variables, batch):
        ev = model.apply(variables, batch, train=False)

        def loss_fn(params):
            preds, upd = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch, train=True, mutable=["batch_stats"],
                rngs=SAMPLER_RNGS)
            losses = model.loss(preds, batch)
            return losses["loss"], (preds, losses, upd["batch_stats"])
        (_, (tpreds, losses, stats)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return ev, model.predict(ev), losses, tpreds, g, stats
    return jax.jit(run)


def _port_run(model, batch, sampled) -> dict:
    """The port's eval forward and ``predict``, then one training forward
    (on the JAX run's sampled RoIs where given), loss and backward."""
    with torch.no_grad():
        ev = model.eval()(batch)
        run = dict(eval=ev, predict=model.predict(ev))
    model.train()
    with pytest.MonkeyPatch.context() as mp:
        if sampled is not None:
            import multimodal_gar_tpu_torch.detection.roi_detectors as proi
            calls = []

            def jax_sampler(generator, cfg, rois, *args):
                i = len(calls) % sampled["rois"].shape[0]
                calls.append(i)
                return {k: v[i] for k, v in sampled.items()}
            mp.setattr(proi, "sample_rois_for_rcnn", jax_sampler)
        losses = model.loss(model(batch), batch)
    losses["loss"].backward()
    run.update(
        losses={k: v.detach() for k, v in losses.items()},
        grads={**{k: p.grad if p.grad is not None else torch.zeros_like(p)
                  for k, p in model.named_parameters()},
               **dict(model.named_buffers())})
    return run


@functools.lru_cache(maxsize=None)
def _runs(name):
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseConv
    j16, port_of, jcfg, jb = _models(name)
    variables = random_variables(j16, jb, train=False, seed=1)
    jv = to_jax(variables)
    model = load_jax_variables(port_of(dataclasses.replace(
        jcfg, dtype="bfloat16")), variables)
    runs = {}
    step16 = _jax_fn(j16)
    nudged = jb.replace(voxels=_nudge(np.asarray(jb.voxels), 2))
    for key, batch in (("ref16", jb), ("drift", nudged)):
        ev, pred, losses, tpreds, grads, stats = jax.device_get(
            step16(jv, batch))
        runs[key] = dict(eval=ev, predict=pred, losses=losses,
                         train_preds=tpreds,
                         grads=expected_tensors(model, grads, stats))
    # the JAX bf16 run's sampled RoIs in place of the port's draws
    tp = runs["ref16"]["train_preds"]
    sampled = ({k: torch.from_numpy(np.array(tp[k])) for k in SAMPLED}
               if name == "PartA2" else None)
    batch = port_batch(jb)
    runs["got"] = _port_run(model, batch, sampled)
    runs["ref32"] = _port_run(load_jax_variables(port_of(jcfg), variables),
                              batch, sampled)
    runs["sparse"] = [f"{n}.weight" for n, m in model.named_modules()
                      if isinstance(m, SparseConv)]
    return runs


def _hold(what, got, ref16, drift, ref32=None) -> bool:
    """One leaf by the module docstring's rules; False where JAX's own
    drift leaves it out."""
    ref = np.asarray(ref16)
    if not np.issubdtype(ref.dtype, np.floating) \
            and ref.dtype != jnp.bfloat16:
        if not np.array_equal(np.asarray(drift), ref):
            return False
        np.testing.assert_array_equal(np.asarray(got), ref, err_msg=what)
        return True
    d = _rel(_f32(drift), _f32(ref16))
    if d > TOL:
        return False
    if ref32 is None:
        err = _rel(_f32(got), _f32(ref16))
        assert err <= TOL, (what, err, d)
    else:
        check_bf16(got, ref16, ref32, what, d)
    return True


def _flat(tree, prefix="") -> dict:
    """Nested dicts of leaves -> {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def check_eval_bf16(r: dict, name: str) -> None:
    """The eval outputs and ``predict`` of runs ``r`` by the rules."""
    for part in ("eval", "predict"):
        got, ref = _flat(r["got"][part]), _flat(r["ref16"][part])
        drift, ref32 = _flat(r["drift"][part]), _flat(r["ref32"][part])
        assert set(got) == set(ref), (part, set(got) ^ set(ref))
        held = [k for k in ref if _hold(f"{name} {part} {k}", got[k], ref[k],
                                        drift[k], ref32[k])]
        print(f"{name} {part}: {len(held)} of {len(ref)} held")
        assert len(held) >= len(ref) / 2, (part, held)
    for k, v in _flat(r["got"]["eval"]).items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k


def check_train_bf16(r: dict, name: str) -> None:
    """The train step of runs ``r`` by the rules."""
    got = r["got"]
    for key, ref in r["ref16"]["losses"].items():
        _hold(f"{name} {key}", got["losses"][key], ref,
              r["drift"]["losses"][key], r["ref32"]["losses"][key])
    ref_grads = r["ref16"]["grads"]
    assert set(got["grads"]) == set(ref_grads)
    drifting = [k for k, ref in ref_grads.items() if not _hold(
        f"{name} grad {k}", got["grads"][k], ref, r["drift"]["grads"][k])]
    for k, g in got["grads"].items():
        assert np.all(np.isfinite(_f32(g))), k
    sparse = r["sparse"]
    assert len(sparse) == {"PartA2": 27, "VoxelNeXt": 31}[name], sparse
    for key in sparse:
        assert torch.count_nonzero(got["grads"][key]) > 0, key
    print(f"{name}: {len(drifting)} of {len(ref_grads)} leaves past bound 1 "
          f"in JAX's own drift: {drifting}")


def _two_stage(name):
    """(JAX model at the bf16 config, the port's model at a config, the
    float32 config, batch, the JAX modules whose vmap runs on item 0)."""
    import multimodal_gar_tpu.detection.roi_detectors as jroi
    from multimodal_gar_tpu_torch.detection import roi_detectors as proi
    from tests.test_torch_det_two_stage import _roi_cfg
    jcfg = tiny_voxel_cfg("SECOND")
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    gen = dict(generator=torch.Generator().manual_seed(0), **CPU)
    if name == "SECONDNetIoU":
        roi = _roi_cfg(use_corner_loss=False)
        jb = with_rulebook(det_batch(jcfg, batch_size=2, seed=3,
                                     m=jcfg.max_voxels_per_stage[0]), jcfg)
        return (jroi.SECONDIoUDetector(jcfg16, roi),
                lambda c: proi.SECONDIoUDetector(port_cfg(c), port_cfg(roi),
                                                 **gen), jcfg, jb, ())
    if name == "PVRCNN":
        import multimodal_gar_tpu.detection.pfe as jax_pfe
        from multimodal_gar_tpu.detection.pfe import SALayerConfig, VSAConfig
        from multimodal_gar_tpu_torch.detection import pfe as port_pfe
        vsa = VSAConfig(num_keypoints=48, num_output_features=16, sa_layers=(
            SALayerConfig("raw_points", 1, (0.8, 1.6), (8, 4),
                          ((8, 8), (8,))),
            SALayerConfig("x_conv2", 2, (1.6,), (8,), ((8,),)),
            SALayerConfig("x_conv4", 8, (3.2,), (4,), ((8,),))),
            use_bev=True, bev_stride=8)
        roi = _roi_cfg(pool_radii=(0.8, 1.6), pool_nsamples=(8, 4),
                       pool_mlps=((8,), (8,)))
        pvsa = port_pfe.VSAConfig(
            vsa.num_keypoints, vsa.num_output_features,
            tuple(port_pfe.SALayerConfig(*dataclasses.astuple(s))
                  for s in vsa.sa_layers), vsa.use_bev, vsa.bev_stride)
        jb = with_points(det_batch(jcfg, batch_size=1, seed=3, m=96), jcfg,
                         160, seed=11, invalid=20)
        return (jroi.PVRCNNDetector(jcfg16, roi, vsa),
                lambda c: proi.PVRCNNDetector(port_cfg(c), port_cfg(roi),
                                              pvsa, **gen),
                jcfg, jb, (jax_pfe, jroi))
    import types
    import multimodal_gar_tpu.detection.post as jpost
    import multimodal_gar_tpu.detection.pv_rcnn_pp as jax_pp
    import multimodal_gar_tpu.detection.roi_heads as jheads
    import multimodal_gar_tpu_torch.detection.post as ppost
    import multimodal_gar_tpu_torch.detection.pv_rcnn_pp as port_pp
    import multimodal_gar_tpu_torch.detection.roi_heads as pheads
    from tests.test_torch_det_next import _pp_cfgs
    jroi_cfg, jpp = _pp_cfgs(types.SimpleNamespace(
        RoIHeadConfig=jroi.RoIHeadConfig,
        RoISamplerConfig=jheads.RoISamplerConfig,
        NMSConfig=jpost.NMSConfig), jax_pp)
    proi_cfg, ppp = _pp_cfgs(types.SimpleNamespace(
        RoIHeadConfig=proi.RoIHeadConfig,
        RoISamplerConfig=pheads.RoISamplerConfig,
        NMSConfig=ppost.NMSConfig), port_pp)
    jb = with_points(det_batch(jcfg, batch_size=2, seed=3, m=96), jcfg, 150,
                     seed=7, invalid=30)
    return (jax_pp.PVRCNNPlusPlusDetector(jcfg16, jroi_cfg, jpp),
            lambda c: port_pp.PVRCNNPlusPlusDetector(port_cfg(c), proi_cfg,
                                                     ppp, **gen),
            jcfg, jb, ())


def check_two_stage_eval_bf16(name: str) -> None:
    """The eval outputs and ``predict`` of two-stage family ``name`` at
    bf16 by the rules: JAX's bf16 eval on the batch and on the nudged one,
    the port's at bf16 and at float32."""
    j16, port_of, jcfg, jb, item_zero = _two_stage(name)
    variables = random_variables(j16, jb, train=False, seed=1)
    jv = to_jax(variables)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in item_zero:
            mp.setattr(mod, "jax", _ItemZeroJax())
        fn = jax.jit(lambda v, b: (lambda ev: (ev, j16.predict(ev)))(
            j16.apply(v, b, train=False)))
        nudged = jb.replace(voxels=_nudge(np.asarray(jb.voxels), 2))
        for key, batch in (("ref16", jb), ("drift", nudged)):
            ev, pred = jax.device_get(fn(jv, batch))
            runs[key] = dict(eval=ev, predict=pred)
    batch = port_batch(jb)
    for key, cfg in (("got", dataclasses.replace(jcfg, dtype="bfloat16")),
                     ("ref32", jcfg)):
        model = load_jax_variables(port_of(cfg), variables).eval()
        with torch.no_grad():
            ev = model(batch)
            runs[key] = dict(eval=ev, predict=model.predict(ev))
    check_eval_bf16(runs, name)


def test_parta2_eval_and_predict_match_jax_bf16():
    """UNetV2 (the encoder on the host rulebook's nbr maps, the decoder's
    subm and inverse convs) and conv_out at bf16, the BEV rounded, the
    heads, the pooling and the refinement float32."""
    check_eval_bf16(_runs("PartA2"), "PartA2")


def test_parta2_train_step_matches_jax_bf16():
    check_train_bf16(_runs("PartA2"), "PartA2")


def test_second_iou_eval_and_predict_match_jax_bf16():
    """SECONDNetIoU's trunk (VoxelBackbone8x over the host rulebook's nbr
    maps, conv_out) at bf16, as the JAX package's; the RoI stage float32
    there and here."""
    check_two_stage_eval_bf16("SECONDNetIoU")
