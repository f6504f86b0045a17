"""Shared helpers of the detector-zoo parity tests (tests/test_torch_det*.py
and tests/test_torch_detectors.py): the JAX package's detector configs and
batches carried over to the port, and one jitted float64 JAX run per model
that returns everything the tests compare."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import multimodal_gar_tpu.detection.detectors as jax_det
import multimodal_gar_tpu.detection.roi_detectors as jax_roi_det
from multimodal_gar_tpu.detection import build_detector as jax_build
import multimodal_gar_tpu_torch.detection.anchors as port_anchors
import multimodal_gar_tpu_torch.detection.dense_heads as port_heads
import multimodal_gar_tpu_torch.detection.detectors as port_detectors
import multimodal_gar_tpu_torch.detection.post as port_post
import multimodal_gar_tpu_torch.detection.roi_detectors as port_roi_det
import multimodal_gar_tpu_torch.detection.roi_heads as port_roi_heads
from multimodal_gar_tpu_torch.convert import convert_variables
from multimodal_gar_tpu_torch.detection import build_detector
from multimodal_gar_tpu_torch.detection.detectors import DetBatch
from tests.test_detection import det_batch
from tests.test_torch_common import assert_close, random_variables, to_jax

TOL = 1e-4
_PORT_CLASSES = {}
for _mod in (port_anchors, port_heads, port_detectors, port_post,
             port_roi_det, port_roi_heads):
    for _name in dir(_mod):
        _obj = getattr(_mod, _name)
        if dataclasses.is_dataclass(_obj) and isinstance(_obj, type):
            _PORT_CLASSES.setdefault(_name, _obj)


def port_cfg(obj):
    """A JAX package config dataclass (nested) as the port's class of the
    same name, field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _PORT_CLASSES[type(obj).__name__]
        return cls(**{f.name: port_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(port_cfg(v) for v in obj)
    return obj


def port_batch(jb, with_rulebook: bool = True) -> DetBatch:
    """The port's DetBatch (CPU tensors) of a JAX DetBatch."""
    def t(v):
        return None if v is None else torch.from_numpy(np.array(v))
    rb = None
    if with_rulebook and jb.rulebook is not None:
        rb = {k: t(v) for k, v in jb.rulebook.items()}
    return DetBatch(voxels=t(jb.voxels), voxel_coords=t(jb.voxel_coords),
                    voxel_num_points=t(jb.voxel_num_points),
                    voxel_valid=t(jb.voxel_valid), gt_boxes=t(jb.gt_boxes),
                    gt_classes=t(jb.gt_classes), gt_valid=t(jb.gt_valid),
                    rulebook=rb, points=t(jb.points),
                    point_valid=t(jb.point_valid), images=t(jb.images),
                    lidar_to_cam=t(jb.lidar_to_cam),
                    cam_to_img=t(jb.cam_to_img),
                    depth_maps=t(jb.depth_maps))


def with_rulebook(jb, cfg):
    """The JAX DetBatch with its host rulebook (the port's copy of
    data/rulebook.py builds the same maps)."""
    from multimodal_gar_tpu.data.rulebook import build_rulebook
    nx, ny, nz = cfg.grid_size
    rbs = [build_rulebook(np.asarray(c), int(np.asarray(v).sum()),
                          (nz + 1, ny, nx), cfg.max_voxels_per_stage,
                          x_window=True)
           for c, v in zip(jb.voxel_coords, jb.voxel_valid)]
    rb = {k: jnp.asarray(np.stack([r[k] for r in rbs])) for k in rbs[0]}
    return jb.replace(rulebook=rb)


def jax_run(model, variables, batch, rngs=None, lr: float = 1e-6):
    """Everything of one JAX detector the tests compare, in one jit and in
    float64: the eval predictions, ``predict`` on them, the training
    forward's predictions and losses, the gradients and the new batch
    statistics, and one optax step (clip 10, AdamW(lr, 0.01)) with Adam's
    first moment.

    float64 because a float32 reference is not one: the tiny models hold
    pre-activations within float32 rounding of a ReLU's kink (VoxelRCNN-Det's
    deblock1 has one at 4.2e-7 in a layer whose values reach 8.3), and a
    float32 run lands on either side of it by its summation order alone.
    One unit on the other side moves every gradient upstream of it by up to
    9% (its training BatchNorm mixes all positions): float32 JAX, op by op
    and jitted, parts from the port there by up to 9e-2. This jit (default
    XLA options) equals the JAX package run op by op in float64 to 6e-14 on
    VoxelRCNN-Det. The JAX package's float32 casts (the detectors' compute
    dtype, the grid pool's layers) are widened for this run.
    """
    rngs = rngs or {}

    def run(variables, batch):
        eval_preds = model.apply(variables, batch, train=False)
        out = model.predict(eval_preds)

        def loss_fn(params):
            preds, upd = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch, train=True, mutable=["batch_stats"], rngs=rngs)
            losses = model.loss(preds, batch)
            return losses["loss"], (preds, losses, upd["batch_stats"])

        (_, (tpreds, losses, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        tx = optax.chain(optax.clip_by_global_norm(10.0),
                         optax.adamw(lr, weight_decay=0.01))
        updates, opt_state = tx.update(grads, tx.init(variables["params"]),
                                       variables["params"])
        # Adam's first moment beside the new weights
        return (eval_preds, out, tpreds, losses, grads, stats,
                optax.apply_updates(variables["params"], updates),
                opt_state[1][0].mu)

    def wide(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
            tree)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_det.DetectorConfig, "compute_dtype",
                   property(lambda self: jnp.float64))
        mp.setattr(jax_roi_det, "ROIGridPool", functools.partial(
            jax_roi_det.ROIGridPool, dtype=jnp.float64))
        keys = ("eval_preds", "predict", "train_preds", "losses", "grads",
                "stats", "new_params", "mu")
        return dict(zip(keys, jax.device_get(
            jax.jit(run)(wide(variables), wide(batch)))))


def det_setup(name, cfg_fn, rulebook: bool, jmodel=None, rngs=None,
              model_fn=None) -> dict:
    """Detector ``name`` at ``cfg_fn(name)``: the JAX model (or ``jmodel``)
    with numpy-drawn weights, the seeded batch of tests/test_detection.py
    (with the host rulebook where ``rulebook``), the JAX run of both
    (jax_run) and ``model_fn(**config_overrides)``, which makes the port's
    model."""
    jcfg = cfg_fn(name)
    jmodel = jmodel or jax_build(name, jcfg)
    # a rulebook's stage 0 holds max_voxels_per_stage[0] rows
    jb = det_batch(jcfg, batch_size=2, seed=3,
                   m=jcfg.max_voxels_per_stage[0] if rulebook else 96)
    if rulebook:
        jb = with_rulebook(jb, jcfg)
    variables = random_variables(jmodel, jb, train=False, seed=1)
    ref = jax_run(jmodel, to_jax(variables), jb, rngs=rngs)
    cfg = port_cfg(jcfg)

    def default_fn(**over):
        return build_detector(name, dataclasses.replace(cfg, **over),
                              device="cpu")
    return dict(cfg=cfg, jb=jb, variables=variables, ref=ref,
                model_fn=model_fn or default_fn)


def expected_tensors(model: torch.nn.Module, params, stats) -> dict:
    """The port's state_dict keys -> values, from flax-layout ``params``
    and ``batch_stats`` trees (gradients or weights)."""
    return {k: v for k, v in convert_variables(
        {"params": params, "batch_stats": stats}, model).items()}


def compare_tree(got: dict, ref: dict, what: str, tol: float = TOL) -> None:
    """Nested dicts of tensors against numpy leaves, key for key."""
    assert set(got) == set(ref), (what, set(got), set(ref))
    for k in ref:
        if isinstance(ref[k], dict):
            compare_tree(got[k], ref[k], f"{what}/{k}", tol)
        else:
            assert_close(got[k].detach().numpy(), np.asarray(ref[k]), tol,
                         f"{what}/{k}")


def compare_predict(got: dict, ref: dict, what: str) -> None:
    """``predict``: the valid sets equal, their boxes and scores to TOL."""
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid,
                                  err_msg=f"{what}: valid")
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]),
                                  err_msg=f"{what}: labels")
    if valid.any():
        assert_close(got["boxes"].numpy()[valid],
                     np.asarray(ref["boxes"])[valid], TOL, f"{what}: boxes")
        assert_close(got["scores"].numpy()[valid],
                     np.asarray(ref["scores"])[valid], TOL,
                     f"{what}: scores")


NOISE_TOL = 1e-3


def check_train(model_fn, variables, batch: DetBatch, ref: dict,
                what: str, lr: float = 1e-6, cancelled=()) -> None:
    """The port's training forward, loss, gradients (and their global norm,
    which sets the clipping) and new BatchNorm statistics, and one train
    step at ``lr`` (the new weights and Adam's first moment), against the
    JAX run ``ref``, every leaf to TOL. ``cancelled``: parameters whose
    gradient is zero in exact arithmetic (a bias followed by a bias-free
    Linear and a training BatchNorm, which subtracts it again); their
    gradient and first moment are noise on both sides, held under
    NOISE_TOL of the largest of any leaf."""
    from multimodal_gar_tpu_torch.convert import load_jax_variables
    from multimodal_gar_tpu_torch.detection.train import (
        create_det_train_state, make_det_train_step)
    model = load_jax_variables(model_fn(), variables).train()
    preds = model(batch)
    losses = model.loss(preds, batch)
    for k in ref["losses"]:
        assert_close(losses[k].detach().numpy(), ref["losses"][k], TOL,
                     f"{what}: loss {k}")
    losses["loss"].backward()
    want = expected_tensors(model, ref["grads"], ref["stats"])
    for name, buf in model.named_buffers():
        assert_close(buf.numpy(), want[name].numpy(), TOL,
                     f"{what}: new {name}")
    largest = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if name in cancelled:
            for side in (g, want[name]):
                assert float(side.abs().max()) <= NOISE_TOL * largest, name
            continue
        assert_close(g.numpy(), want[name].numpy(), TOL,
                     f"{what}: grad {name}")
    norm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                          for p in model.parameters() if p.grad is not None))
    ref_norm = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                           for g in jax.tree_util.tree_leaves(ref["grads"])))
    assert_close(norm.numpy(), ref_norm, TOL, f"{what}: gradient norm")

    model = load_jax_variables(model_fn(), variables)
    state = create_det_train_state(model, learning_rate=lr)
    metrics = make_det_train_step(model, state)(batch)
    assert float(metrics["nonfinite_grads"]) == 0.0
    want = expected_tensors(model, ref["new_params"], ref["stats"])
    for name, t in model.state_dict().items():
        assert_close(t.numpy(), want[name].numpy(), TOL,
                     f"{what}: after one step, {name}")
    # the clipped gradients reach Adam's first moment
    mu = expected_tensors(model, ref["mu"], ref["stats"])
    largest = max(float(m.abs().max()) for m in mu.values())
    for name, p in model.named_parameters():
        got = state.optimizer.state[p]["exp_avg"]
        if name in cancelled:
            for side in (got, mu[name]):
                assert float(side.abs().max()) <= NOISE_TOL * largest, name
            continue
        assert_close(got.numpy(), mu[name].numpy(), TOL,
                     f"{what}: Adam mu {name}")


# ---------------------------------------------------------------------------
# the zoo's second slice: families with raw points, fed the JAX sampler
# ---------------------------------------------------------------------------

SAMPLER_RNGS = {"sampler": jax.random.PRNGKey(8),
                "dropout": jax.random.PRNGKey(9)}
SAMPLED = ("rois", "gt_of_rois", "gt_iou_of_rois", "roi_scores",
           "roi_labels", "roi_valid", "reg_valid_mask", "rcnn_cls_labels")


def with_points(jb, cfg, n: int, seed: int, invalid: int = 0):
    """The JAX DetBatch with (B, n, 4) raw points drawn uniformly in the
    point-cloud range (intensity in [0, 1)); the last item's final
    ``invalid`` points are padding."""
    b = jb.voxels.shape[0]
    pr = cfg.point_cloud_range
    rng = np.random.default_rng(seed)
    pts = rng.uniform(low=[pr[0], pr[1], pr[2], 0.0],
                      high=[pr[3], pr[4], pr[5], 1.0],
                      size=(b, n, 4)).astype(np.float32)
    pv = np.ones((b, n), bool)
    if invalid:
        pv[-1, n - invalid:] = False
        pts[-1, n - invalid:] = 0.0
    return jb.replace(points=jnp.asarray(pts), point_valid=jnp.asarray(pv))


class _ItemZeroJax:
    """``jax`` with ``vmap`` replaced by one call on item 0 (a batch of
    one): a JAX module whose BatchNorms run under ``jax.vmap`` leaks its
    running statistics from a training apply (ROADMAP Queue 3), and at
    batch 1 the unbatched call is the same function."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def vmap(fn, *args, **kwargs):
        assert not args and not kwargs, "in_axes / out_axes not handled"

        def call(*a, **k):
            first = functools.partial(jax.tree_util.tree_map,
                                      lambda x: x[0])
            out = fn(*first(a), **first(k))
            return jax.tree_util.tree_map(lambda x: x[None], out)
        return call


def family_setup(jmodel, jb, model_fn, item_zero_modules=()) -> dict:
    """numpy-drawn weights of ``jmodel`` for batch ``jb``, the float64
    JAX run of both (jax_run, the RoI sampler on SAMPLER_RNGS), and
    ``model_fn()`` which makes the port's model on the CPU. In the JAX
    modules of ``item_zero_modules`` ``jax.vmap`` is one call on item 0
    (``_ItemZeroJax``; jb must hold one item)."""
    variables = random_variables(jmodel, jb, train=False, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        for mod in item_zero_modules:
            assert jb.voxels.shape[0] == 1
            mp.setattr(mod, "jax", _ItemZeroJax())
        ref = jax_run(jmodel, to_jax(variables), jb, rngs=SAMPLER_RNGS)
    return dict(jb=jb, variables=variables, ref=ref, model_fn=model_fn)


def check_eval(setup: dict, what: str) -> dict:
    """The port's eval forward and ``predict`` against the JAX run; returns
    the port's eval predictions."""
    from multimodal_gar_tpu_torch.convert import load_jax_variables
    model = load_jax_variables(setup["model_fn"](), setup["variables"]).eval()
    with torch.no_grad():
        preds = model(port_batch(setup["jb"]))
        out = model.predict(preds)
    ref = setup["ref"]
    compare_tree(preds, ref["eval_preds"], what)
    compare_predict(out, ref["predict"], what)
    return preds


def check_train_with_jax_sampler(setup: dict, what: str, monkeypatch,
                                 cancelled=()) -> None:
    """check_train with the JAX run's sampled RoIs fed to the port's
    two-stage path in place of its own sampler (which draws from another
    generator), every item of both training forwards."""
    import multimodal_gar_tpu_torch.detection.roi_detectors as port_roi
    ref = setup["ref"]
    sampled = {k: torch.from_numpy(np.array(
        ref["train_preds"][k], np.float32 if np.issubdtype(
            ref["train_preds"][k].dtype, np.floating) else None))
        for k in SAMPLED}
    calls = []

    def jax_sampler(generator, cfg, rois, *args):
        i = len(calls) % sampled["rois"].shape[0]
        calls.append(i)
        return {k: v[i] for k, v in sampled.items()}

    monkeypatch.setattr(port_roi, "sample_rois_for_rcnn", jax_sampler)
    check_train(setup["model_fn"], setup["variables"],
                port_batch(setup["jb"]), ref, what, cancelled=cancelled)
    assert len(calls) == 2 * sampled["rois"].shape[0]
