"""The trainable I3D (``i3d_freeze: false``) against the JAX package's.

- The RGB branch in training with the I3D trainable: the I3D runs conv ->
  training BatchNorm -> ReLU in every Unit3D (the stem's conv by XLA /
  F.conv3d), no cone cull, its 45 BatchNorms' statistics move; output and
  every statistic to 1e-4 of the largest reference value.
- InceptionI3d's training forward through Conv3d_2c_3x3 (the stem's
  training conv and both plain Unit3Ds), and one Inception module (its
  max-pool branch included) on its own: output, statistics and every
  parameter gradient to 1e-4; through Mixed_3b the port's float32
  gradients against its own float64 run, to 1e-4.
- ``remat`` against none through Mixed_4b (the port against itself, bit
  for bit).
- A tiny MGAR with the trainable I3D: a Kinetics-style I3D checkpoint
  loads into it, one train step moves every I3D weight and statistic, and
  a checkpoint restores them with their Adam moments; the JAX optimizer's
  I3D moments convert onto a trainable RGB branch.

Gradients through a whole stack past a max pool are not compared with the
JAX package: the pool's gradient goes to the argmax of each window, and
where two values of a window lie within float32 rounding of each other,
sums in another order pick another one. The gradient of a random probe, a
sum of terms of either sign, then moves by percents for a handful of such
windows: by hand on the CPU, the JAX package's float32 gradients part from
a float64 run of the port by percents from MaxPool3d_3a on, and its jitted
ones from its eager ones. The port's float32 gradients through Mixed_3b
are held to a float64 run of the port instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodal_gar_tpu.models.i3d import InceptionI3d as JaxI3d
from multimodal_gar_tpu.models.i3d import (
    InceptionModule as JaxInceptionModule)
from multimodal_gar_tpu.models.rgb_backbone import RGBBackbone as JaxRGB
from multimodal_gar_tpu_torch.convert import _target, convert_optimizer_state
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.models.i3d import (InceptionI3d,
                                                 InceptionModule)
from multimodal_gar_tpu_torch.models.i3d_convert import load_i3d_checkpoint
from multimodal_gar_tpu_torch.models.rgb_backbone import RGBBackbone
from multimodal_gar_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_gar_tpu_torch.train.train_state import (
    TrainState, make_optimizer, make_train_step)
from multimodal_gar_tpu_torch.utils.testing import (
    batch_from_numpy, condition_for_grad_parity_, randomize_,
    synthetic_batch_numpy, tiny_config)
from tests.test_torch_common import (assert_close, port_module,
                                     random_variables, to_jax)

TOL = 1e-4
# 7 frames: odd T, where the eval cone cull would apply (the RGB branch
# turns it off while the I3D trains, and so do both sides here)
SHAPE = (2, 7, 48, 64, 3)


def _jax_training(endpoint: str):
    """The JAX I3D's training forward on a white-noise clip (no two pixels
    of a max-pool window tie): (clip, variables, probe, output, new
    statistics, gradients of sum(output * probe) in the port's layout)."""
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    jmod = JaxI3d(final_endpoint=endpoint, center_slice=False)
    variables = random_variables(jmod, jnp.asarray(x), train=False, seed=1)
    out_shape = jax.eval_shape(lambda v, a: jmod.apply(
        v, a, train=True, mutable=["batch_stats"])[0],
        to_jax(variables), jnp.asarray(x)).shape
    probe = np.random.default_rng(2).normal(size=out_shape).astype(
        np.float32)

    def loss(params, stats, a):
        out, upd = jmod.apply({"params": params, "batch_stats": stats}, a,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out * probe), (out, upd["batch_stats"])
    v = to_jax(variables)
    grads, (out, stats) = jax.jit(jax.grad(loss, has_aux=True))(
        v["params"], v["batch_stats"], jnp.asarray(x))
    grads = dict(_target("params", p, np.asarray(g))
                 for p, g in flatten_dict(grads).items())
    stats = dict(_target("batch_stats", p, np.asarray(s))
                 for p, s in flatten_dict(stats).items())
    return x, variables, probe, np.asarray(out), stats, grads


def _port_training(endpoint, variables, x, probe, remat=False):
    mod = port_module(InceptionI3d, endpoint, remat=remat,
                      variables=variables)
    return _train_forward(mod, x, probe)


def _train_forward(mod, x, probe):
    """(output, BatchNorm statistics after, parameter gradients of
    sum(output * probe)) of ``mod``'s training forward on ``x``."""
    mod.train()
    out = mod(torch.from_numpy(x))
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(),
                                list(mod.parameters()))
    grads = {k: g for (k, _), g in zip(mod.named_parameters(), grads)}
    stats = {k: v.clone() for k, v in mod.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return out.detach(), stats, grads


def test_training_i3d_matches_jax():
    """Through Conv3d_2c_3x3: output, statistics and every gradient."""
    endpoint = "Conv3d_2c_3x3"
    x, variables, probe, ref, ref_stats, ref_grads = _jax_training(endpoint)
    out, stats, grads = _port_training(endpoint, variables, x, probe)
    assert out.shape == ref.shape
    assert_close(out.numpy(), ref, TOL, "output")
    assert set(stats) == set(ref_stats)
    for k, want in ref_stats.items():
        assert_close(stats[k].numpy(), want, TOL, k)
    before = dict(_target("batch_stats", p, s) for p, s in
                  flatten_dict(variables["batch_stats"]).items())
    assert all(not np.array_equal(before[k], ref_stats[k]) for k in before)
    assert set(grads) == set(ref_grads)
    for k, want in ref_grads.items():
        assert_close(grads[k].numpy(), want, TOL, k)
    assert float(np.abs(ref_grads["Conv3d_1a_7x7.conv3d.weight"]).max()) > 0


def test_trainable_rgb_backbone_matches_jax():
    """The RGB branch with ``i3d_freeze: false`` in training: the I3D
    trains (full temporal extent, training BatchNorms whose statistics
    move) under the non-local block and the embedding. Block-structured
    frames and person-sized boxes: the non-local block's training BatchNorm
    needs rows that differ (utils/testing.py: condition_for_grad_parity_)."""
    cfg = tiny_config()
    rcfg = dataclasses.replace(cfg.model.rgb, i3d_freeze=False)
    f = condition_for_grad_parity_(synthetic_batch_numpy(
        cfg, batch_size=2, seed=0, n_valid=cfg.data.num_boxes))
    jmod = JaxRGB(rcfg)
    jargs = [jnp.asarray(f[k]) for k in ("images", "boxes2d")]
    kw = dict(valid=jnp.asarray(f["person_valid"]))
    variables = random_variables(jmod, *jargs, train=False, seed=2, **kw)
    variables["params"]["self_att"]["W_z"]["bias"][:] = 0.0
    ref, upd = jax.jit(lambda v, *a: jmod.apply(
        v, *a, train=True, mutable=["batch_stats"], **kw))(
        to_jax(variables), *jargs)
    mod = port_module(RGBBackbone, rcfg, variables=variables).train()
    assert mod.i3d.training
    with torch.no_grad():
        got = mod(*[torch.from_numpy(f[k]) for k in ("images", "boxes2d",
                                                      "person_valid")])
    assert_close(got.numpy(), ref, TOL, "RGBBackbone")
    state = mod.state_dict()
    flat = flatten_dict(upd["batch_stats"])
    assert sum(p[0] == "i3d" for p in flat) == 90      # 45 BatchNorms
    for path, v in flat.items():
        key, want = _target("batch_stats", path, np.asarray(v))
        assert_close(state[key].numpy(), want, TOL, key)
        before = flatten_dict(variables["batch_stats"])[path]
        assert not np.array_equal(before, want), key


def test_training_gradients_match_a_float64_run_through_mixed_3b():
    """Past the first max pools the JAX reference is ill-conditioned (see
    above); the port's float32 training gradients through Mixed_3b equal
    those of the same module in float64 to 1e-4."""
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    probe = np.random.default_rng(2).normal(size=(2, 4, 6, 8, 256)).astype(
        np.float32)
    runs = []
    for dtype in (torch.float32, torch.float64):
        mod = InceptionI3d("Mixed_3b", device="cpu",
                           generator=torch.Generator().manual_seed(0))
        randomize_(mod, torch.Generator().manual_seed(1))
        mod.to(dtype).train()
        out = mod(torch.from_numpy(x).to(dtype))
        runs.append(torch.autograd.grad(
            (out * torch.from_numpy(probe).to(dtype)).sum(),
            list(mod.parameters())))
    for (k, _), got, want in zip(mod.named_parameters(), *runs):
        assert_close(got.numpy(), want.numpy(), TOL, k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "training"])
def test_inception_module_matches_jax(train):
    """Mixed_4f's module on post-ReLU input: output, statistics and, in
    training, the gradients of its 18 parameters and of its input."""
    x = np.maximum(np.random.default_rng(3).normal(size=(2, 3, 5, 6, 64)),
                   0).astype(np.float32)
    oc = [16, 12, 20, 4, 8, 8]
    jmod = JaxInceptionModule(oc)
    variables = random_variables(jmod, jnp.asarray(x), train=False, seed=4)
    probe = np.random.default_rng(5).normal(
        size=x.shape[:-1] + (sum(oc[i] for i in (0, 2, 4, 5)),)).astype(
        np.float32)

    def loss(v, a):
        out, upd = jmod.apply(v, a, train=train, mutable=["batch_stats"])
        return jnp.sum(out * probe), (out, upd)
    (g, gx), (ref, upd) = jax.jit(jax.grad(loss, argnums=(0, 1),
                                           has_aux=True))(
        to_jax(variables), jnp.asarray(x))
    mod = port_module(InceptionModule, 64, oc, variables=variables)
    mod.train(train)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_(train)
    out = mod(xt).permute(0, 2, 3, 4, 1)
    assert_close(out.detach().numpy(), ref, TOL, "output")
    if not train:
        return
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(),
                                [xt] + list(mod.parameters()))
    assert_close(grads[0].permute(0, 2, 3, 4, 1).numpy(), gx, TOL, "input")
    want = dict(_target("params", p, np.asarray(a))
                for p, a in flatten_dict(g["params"]).items())
    for (k, _), got in zip(mod.named_parameters(), grads[1:]):
        assert_close(got.numpy(), want[k], TOL, k)
    state = mod.state_dict()
    for p, v in flatten_dict(upd["batch_stats"]).items():
        key, arr = _target("batch_stats", p, np.asarray(v))
        assert_close(state[key].numpy(), arr, TOL, key)


def test_remat_gives_the_same_outputs_gradients_and_statistics():
    """Through Mixed_4b (three Inception modules, the stride-2 pools
    between them), the port against itself: outputs, statistics (moved once,
    not again in the recompute) and gradients bit for bit."""
    x = np.random.default_rng(0).normal(size=(1, 5, 32, 48, 3)).astype(
        np.float32)
    probe = np.random.default_rng(2).normal(size=(1, 2, 2, 3, 512)).astype(
        np.float32)
    runs = []
    for remat in (False, True):
        mod = InceptionI3d("Mixed_4b", remat=remat, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        randomize_(mod, torch.Generator().manual_seed(1))
        if not runs:
            initial = {k: v.clone() for k, v in mod.state_dict().items()}
        runs.append(_train_forward(mod, x, probe))
    (out, stats, grads), (r_out, r_stats, r_grads) = runs
    assert torch.equal(r_out, out)
    for k in stats:
        assert torch.equal(r_stats[k], stats[k]), k
        assert not torch.equal(stats[k], initial[k]), k
    for k in grads:
        assert torch.equal(r_grads[k], grads[k]), k


def test_train_step_moves_the_trainable_i3d(tmp_path):
    """A Kinetics-style I3D checkpoint loads into the trainable I3D, one
    train step moves all its weights and statistics, and a checkpoint of
    the train state restores them and their Adam moments. RGB only: the
    LiDAR branch adds nothing here but small operations, which the test
    run's parallel workers make expensive."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rgb=dataclasses.replace(cfg.model.rgb, i3d_freeze=False),
        fusion=dataclasses.replace(cfg.model.fusion, modality="RGB")))
    model = MGAR(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                         steps_per_epoch=8, grad_accum=1, gamma=0.9)
    i3d = model.rgb_backbone.i3d
    # a state dict under the published key names, which are the port's own
    published = {k: v.numpy() + 0.5 for k, v in i3d.state_dict().items()}
    load_i3d_checkpoint(model, published)
    for k, v in i3d.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), published[k], err_msg=k)
    assert all(p.requires_grad for p in i3d.parameters())
    names = {id(p) for p in i3d.parameters()}
    assert sum(id(p) in names for p in opt.params) == len(names) > 0
    before = {k: v.clone() for k, v in i3d.state_dict().items()}
    model.train()
    assert i3d.training
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(model, opt, "L_total", state=state)
    metrics = step(batch_from_numpy(synthetic_batch_numpy(cfg, 1, seed=0)))
    state.step += 1
    assert metrics["nonfinite_grads"] == 0.0
    after = {k: v.clone() for k, v in i3d.state_dict().items()}
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert "Conv3d_1a_7x7.conv3d.weight" in moved
    assert "Mixed_4f.b3b.bn.running_var" in moved
    assert len(moved) == len(before)

    CheckpointManager(str(tmp_path)).save(1, state)
    saved = opt.state_dict()
    with torch.no_grad():
        for t in i3d.state_dict().values():
            t.zero_()
    fresh_opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                               steps_per_epoch=8, grad_accum=1, gamma=0.9)
    CheckpointManager(str(tmp_path)).restore(
        TrainState(model=model, optimizer=fresh_opt))
    for k, v in after.items():
        assert torch.equal(i3d.state_dict()[k], v), k
    restored = fresh_opt.state_dict()
    for key in ("exp_avg", "exp_avg_sq"):
        assert all(torch.equal(a, b)
                   for a, b in zip(saved[key], restored[key]))


def test_adam_moments_of_the_trainable_i3d_convert():
    """convert_optimizer_state places the JAX optimizer's I3D moments on the
    trainable I3D of the RGB branch (a frozen one takes only zero
    leaves)."""
    cfg = tiny_config()
    rcfg = dataclasses.replace(cfg.model.rgb, i3d_freeze=False)
    f = synthetic_batch_numpy(cfg, batch_size=1, seed=0)
    params = random_variables(JaxRGB(rcfg), jnp.asarray(f["images"]),
                              jnp.asarray(f["boxes2d"]), train=False,
                              seed=3)["params"]
    model = RGBBackbone(rcfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                         steps_per_epoch=8, grad_accum=1, gamma=0.9)
    opt.load_state_dict(convert_optimizer_state(model, params, params, 4))
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    i = names.index("i3d.Conv3d_1a_7x7.conv3d.weight")
    kernel = params["i3d"]["Conv3d_1a_7x7"]["conv3d"]["kernel"]
    want = torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy())
    assert torch.equal(opt.adam.state[opt.params[i]]["exp_avg"], want)
    assert opt.updates == 4
    frozen = RGBBackbone(cfg.model.rgb, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frozen"):
        convert_optimizer_state(frozen, params, params, 4)
