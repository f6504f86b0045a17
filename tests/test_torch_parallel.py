"""The port's parallel layer (multimodal_gar_tpu_torch/parallel/) against one
process and against the JAX package: data parallelism is a layout, not a
change of the math (tests/test_multichip_flagship.py,
tests/test_detection_train.py), and the collectives are the ones it needs
(tests/test_multichip_hlo.py).

The world-2 cases run in two gloo processes on the CPU, one group per mesh
shape (data 2 x fsdp 1 and data 1 x fsdp 2), each started once by the
module's fixture and running every case of its shape
(utils/parallel_testing.py: spawn). The same case functions run in this
process without a mesh give the world-1 reference.

- (a) ``make_mesh``'s rules, and the fsdp rule on the JAX model's parameter
  shapes: JAX's ``fsdp_param_sharding`` at fsdp 1, 2 and 4 on the 8
  virtual CPU devices, and hand-written axes.
- (b) tiny_config MGAR, ``grad_accum_steps`` 1, a global batch of 4
  (conditioned as tests/test_torch_train_step.py's, dropout off on both
  sides; 8 people on one rank, 5 on the other), one step at data 2
  against the port's world-1 step and the JAX single-device step, at that
  test's tolerances: loss 1e-5, gradients
  (Adam's first moment after one update is 0.1 g) 1e-4 of each leaf's
  largest, BatchNorm statistics 1e-5, the updated parameters at lr 1e-6
  within 2 lr (Adam's first update is lr * sign(g), so a noise-level
  gradient may flip it) of the world-1 step's.
- (c) the same at data 1 x fsdp 2: each rank holds half of every split
  leaf.
- (d) the collectives of the real step, recorded round torch.distributed:
  a gradient all-reduce of at least the parameter bytes and no all-gather
  at data 2; at fsdp 2 a reduce-scatter of the split gradients and
  all-gathers of exactly the split parameters. A step whose batch is
  replicated and not reduced fails the data-2 check.
- (e) the multihost functions at world 1 and 2.
- (f) a tiny SECOND step through ``shard_det_batch`` at data 2 against the
  world-1 step on the same batch of 2.
- Dropout under a mesh draws the global batch's mask and keeps its rows.
- The checks' own check: with each fault of data parallelism planted in
  the ranks (utils/parallel_testing.py: planted_fault), (b)'s and (f)'s
  checks fail.
"""
import dataclasses
import shutil
from concurrent.futures import ThreadPoolExecutor

import flax.linen
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax.traverse_util import flatten_dict

from multimodal_gar_tpu.config import MeshConfig as JaxMeshConfig
from multimodal_gar_tpu.models import MGAR as JaxMGAR
from multimodal_gar_tpu.parallel import mesh as jax_mesh
from multimodal_gar_tpu.train import losses as jax_losses
from multimodal_gar_tpu_torch.config import MeshConfig
from multimodal_gar_tpu_torch.convert import _target
from multimodal_gar_tpu_torch.detection import build_detector
from multimodal_gar_tpu_torch.models import MGAR
from multimodal_gar_tpu_torch.parallel import multihost
from multimodal_gar_tpu_torch.parallel.mesh import (axis_size, make_mesh,
                                                    split_axis)
from multimodal_gar_tpu_torch.utils import parallel_testing as pt
from multimodal_gar_tpu_torch.utils.testing import (
    BN_CANCELLED_BIASES, condition_for_grad_parity_, prepare_grad_parity_,
    synthetic_batch_numpy, tiny_config, tiny_det_batch, tiny_detector_config,
    uneven_people_)
from tests.test_torch_common import (assert_close, exact_pool_config,
                                     jax_batch, port_module, random_variables,
                                     to_jax)

LR = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STATS_TOL = 1e-5
NOISE_TOL = 1e-3          # BN_CANCELLED_BIASES, as test_torch_train_step.py
# SECOND's losses normalise per sample: a rank-local count changes nothing
DET_FAULTS = ("bn_local", "no_grad_reduce")


def _jax_reference(cfg, fields):
    """The JAX model's numpy-drawn variables (as test_torch_train_step.py
    sets them) and its single-device loss, gradients and new BatchNorm
    statistics on the global batch, dropout off."""
    jb = jax_batch(fields)
    jmodel = JaxMGAR(cfg)
    variables = random_variables(jmodel, jb, train=False, seed=0)
    d_embed = variables["params"]["gar_fusion"]["D_embed"]
    d_embed["kernel"] = np.array([[1.0], [4.0]], np.float32)
    d_embed["bias"] = np.array([0.3], np.float32)
    w_z = variables["params"]["rgb_backbone"]["self_att"]["W_z"]
    w_z["bias"] = np.zeros_like(w_z["bias"])

    def loss_fn(params, batch_stats):
        out, updates = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, jb, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        losses = jax_losses.compute_losses(out, jb)
        return (jax_losses.total_loss(losses, "L_total"),
                (losses, updates["batch_stats"]))

    jv = to_jax(variables)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        (loss, (_, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jv["params"], jv["batch_stats"])
    return variables, dict(loss=float(loss), grads=grads, stats=stats)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = exact_pool_config(tiny_config())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=1))
    # the two ranks hold 8 and 5 people, so that a loss that divided by
    # its rank's count instead of the global one would differ
    fields = condition_for_grad_parity_(uneven_people_(
        synthetic_batch_numpy(cfg, batch_size=4, seed=0), (4, 4, 2, 3)))
    variables, jax_ref = _jax_reference(cfg, fields)
    model = prepare_grad_parity_(port_module(MGAR, cfg, variables=variables))
    step_kw = dict(cfg=cfg, fields=fields, state_dict=model.state_dict(),
                   lr=LR, dropout=False)
    det_cfg = tiny_detector_config("SECOND")
    det_kw = dict(name="SECOND", det_cfg=det_cfg, in_channels=4,
                  batch=tiny_det_batch(det_cfg, batch_size=2),
                  state_dict=build_detector("SECOND", det_cfg,
                                            device="cpu").state_dict(),
                  lr=LR)
    masks_kw = dict(shape=(4, 3, 5))
    root = tmp_path_factory.mktemp("parallel")
    world1_step = pt.mgar_steps(full_state=True, **step_kw)
    _write_checkpoint(cfg, world1_step, str(root / "world1_ckpt"))
    data2 = {"mesh": (2, 1), "device": "cpu", "threads": 2, "cases": [
        ("step", "mgar_steps", step_kw),
        ("broken", "mgar_steps", dict(step_kw, broken=True, states=False)),
        ("det", "det_step", det_kw),
        ("masks", "dropout_masks", masks_kw),
        ("multihost", "multihost", {})]
        + [(("step", f), "mgar_steps", dict(step_kw, fault=f))
           for f in pt.FAULTS]
        + [(("det", f), "det_step", dict(det_kw, fault=f))
           for f in DET_FAULTS]}
    fsdp2 = {"mesh": (1, 2), "device": "cpu", "threads": 2, "cases": [
        ("step", "mgar_steps", step_kw),
        ("resumed", "checkpoint_roundtrip", dict(
            cfg=cfg, source=str(root / "world1_ckpt"),
            target=str(root / "fsdp2_ckpt")))]}
    with ThreadPoolExecutor(2) as pool:
        spawned = {name: pool.submit(pt.spawn, 2, job, str(root / name))
                   for name, job in (("data2", data2), ("fsdp2", fsdp2))}
        world1 = dict(step=world1_step,
                      det=pt.det_step(**det_kw),
                      masks=pt.dropout_masks(**masks_kw),
                      multihost=pt.multihost())
        out = {name: f.result() for name, f in spawned.items()}
    world1["resumed"] = pt.checkpoint_roundtrip(
        cfg=cfg, source=str(root / "fsdp2_ckpt"),
        target=str(root / "world1_again"))
    files = [torch.load(str(root / d / "step_1.pt"), weights_only=True)
             for d in ("world1_ckpt", "fsdp2_ckpt")]
    out["ckpt_differ"] = pt.different_tensors(files[1], files[0])
    del files
    shutil.rmtree(root)          # the checkpoints: ~0.7 GB at tiny_config
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    return dict(world1=world1, jax=jax_ref, names=names,
                start=model.state_dict(), jax_params=variables["params"],
                **out)


def _write_checkpoint(cfg, step: dict, directory: str) -> None:
    """``step``'s model and optimizer state (a mgar_steps result) as a
    checkpoint of step 1 in ``directory``."""
    from multimodal_gar_tpu_torch.train.checkpoint import CheckpointManager
    from multimodal_gar_tpu_torch.train.train_state import (TrainState,
                                                            make_optimizer)
    model = MGAR(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(step["model"])
    opt = make_optimizer(model.parameters(), cfg.train.stages[0], 8, 1, 1.0)
    opt.load_state_dict(step["optimizer"])
    CheckpointManager(directory).save(1, TrainState(model=model,
                                                   optimizer=opt))


# -- (a) the mesh -------------------------------------------------------------

def test_make_mesh_rules(tmp_path):
    """No group: raises. In a world-1 group: data = -1 takes the processes
    the fsdp axis leaves, and data x fsdp must equal the world."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(MeshConfig(), "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(data=-1, fsdp=1), "cpu")
        assert mesh.mesh_dim_names == ("data", "fsdp")
        assert (axis_size(mesh, "data"), axis_size(mesh, "fsdp")) == (1, 1)
        with pytest.raises(AssertionError, match="mesh 2x1 != 1"):
            make_mesh(MeshConfig(data=2, fsdp=1), "cpu")
    finally:
        dist.destroy_process_group()


# hand-written: the largest axis fsdp divides, the first of equal ones
HAND_AXES = {((27, 16, 32), 2): 2, ((27, 16, 32), 4): 2,
             ((27, 16, 32), 8): 2, ((832, 512), 2): 0, ((512, 512), 4): 0,
             ((7, 7, 7, 3, 64), 2): 4, ((3, 5), 2): None, ((), 2): None,
             ((6,), 4): None, ((2, 96), 4): 1, ((96, 27), 8): 0,
             ((16,), 1): None}


@pytest.mark.parametrize("fsdp", [1, 2, 4])
def test_fsdp_rule_is_the_jax_rule_on_the_jax_parameter_shapes(runs, fsdp):
    shapes = runs["jax_params"]
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=8 // fsdp, fsdp=fsdp))
    ref = flatten_dict(jax_mesh.fsdp_param_sharding(shapes, mesh))
    split = 0
    for path, s in flatten_dict(shapes).items():
        spec = tuple(ref[path].spec)
        want = spec.index("fsdp") if "fsdp" in spec else None
        assert split_axis(s.shape, fsdp) == want, path
        split += want is not None
    assert (split > 100) == (fsdp > 1)
    for (shape, f), want in HAND_AXES.items():
        if f == fsdp or (fsdp == 4 and f == 8):
            assert split_axis(shape, f) == want, (shape, f)


# -- (b), (c) the MGAR step ---------------------------------------------------

def _check_step_against_world1(got: dict, ref: dict, names) -> None:
    for k, v in ref["metrics"][0].items():
        assert_close(got["metrics"][0][k], v, LOSS_TOL, k)
    mu, ref_mu = got["optimizer"]["exp_avg"], ref["optimizer"]["exp_avg"]
    largest = max(float(t.abs().max()) for t in ref_mu)
    for name, a, b in zip(names, mu, ref_mu):
        if name in BN_CANCELLED_BIASES:
            for side in (a, b):
                assert float(side.abs().max()) <= NOISE_TOL * largest, name
        elif b.any():
            assert_close(a.numpy(), b.numpy(), GRAD_TOL, name)
        else:
            assert not a.any(), name           # card_net: no gradient
    for key, b in ref["model"].items():
        a = got["model"][key]
        if key.endswith(("running_mean", "running_var")):
            assert_close(a.numpy(), b.numpy(), STATS_TOL, key)
        elif b.is_floating_point():
            assert float((a - b).abs().max()) <= 2 * LR + 1e-6 * float(
                b.abs().max()), key
    assert got["optimizer"]["updates"] == ref["optimizer"]["updates"] == 1


def _check_step_against_jax(got: dict, jax_ref: dict, names) -> None:
    assert_close(got["metrics"][0]["loss"], jax_ref["loss"], LOSS_TOL,
                 "loss")
    refs = dict(_target("params", path, np.asarray(g))
                for path, g in flatten_dict(jax_ref["grads"]).items())
    mu = dict(zip(names, got["optimizer"]["exp_avg"]))
    checked = 0
    for name, g in mu.items():
        ref = refs[name]
        grad = g.numpy() / 0.1                   # (1 - b1) g after one step
        if name in BN_CANCELLED_BIASES:
            scale = np.abs(refs[name.replace(".bias", ".weight")]).max()
            assert np.abs(grad).max() <= NOISE_TOL * scale, name
        else:
            assert_close(grad, ref, GRAD_TOL, name)
            checked += 1
    assert checked > 100
    stats = flatten_dict(jax.tree_util.tree_map(np.asarray,
                                                jax_ref["stats"]))
    for path, v in stats.items():
        key, ref = _target("batch_stats", path, v)
        assert_close(got["model"][key].numpy(), ref, STATS_TOL, key)


def test_world1_step_matches_jax(runs):
    step = runs["world1"]["step"]
    _check_step_against_jax(step, runs["jax"], runs["names"])
    moved = sum(not torch.equal(step["model"][k], v)
                for k, v in runs["start"].items())
    assert moved > 100                      # the step did update


@pytest.mark.parametrize("rank", [0, 1])
def test_data2_step_matches_world1_and_jax(runs, rank):
    got = runs["data2"][rank]["step"]
    _check_step_against_world1(got, runs["world1"]["step"], runs["names"])
    _check_step_against_jax(got, runs["jax"], runs["names"])


@pytest.mark.parametrize("rank", [0, 1])
def test_fsdp2_step_matches_world1_and_jax(runs, rank):
    got = runs["fsdp2"][rank]["step"]
    _check_step_against_world1(got, runs["world1"]["step"], runs["names"])
    _check_step_against_jax(got, runs["jax"], runs["names"])


def test_fsdp2_ranks_hold_half_of_every_split_leaf(runs):
    split = 0
    for full, held in runs["fsdp2"][0]["step"]["held"]:
        axis = split_axis(full, 2)
        want = list(full)
        if axis is not None:
            want[axis] //= 2
            split += 1
        assert tuple(held) == tuple(want), (full, held)
    assert split > 100
    unsplit = runs["world1"]["step"]["held"]
    assert all(tuple(f) == tuple(h) for f, h in unsplit)


def test_checkpoints_move_between_world_1_and_fsdp_2(runs):
    """A checkpoint holds full tensors: the fsdp-2 ranks restore the
    world-1 step's checkpoint into their slices, their gathered state is
    the file's bit for bit, and the checkpoint they save (rank 0 writes)
    is the world-1 file again, which a world-1 process restores."""
    for rank in (0, 1):
        got = runs["fsdp2"][rank]["resumed"]
        assert got["step"] == 1 and got["differ"] == [], got
    assert runs["ckpt_differ"] == []
    again = runs["world1"]["resumed"]
    assert again["step"] == 1 and again["differ"] == []


# -- (d) the collectives ------------------------------------------------------

def _split_bytes(step: dict) -> int:
    return sum(int(np.prod(f)) * 4 for f, _ in step["held"]
               if split_axis(f, 2) is not None)


def check_data_parallel_collectives(step: dict) -> None:
    """At data 2: the gradient is all-reduced over the data group (at
    least the parameter bytes), and nothing is all-gathered."""
    log = step["collectives"]
    reduced = sum(c["bytes"] for c in log
                  if c["op"] == "all_reduce" and c["group"] == 2)
    assert reduced >= step["param_bytes"], \
        f"gradient all-reduce of {reduced} bytes < {step['param_bytes']}"
    gathers = [c for c in log if c["op"].startswith("all_gather")]
    assert not gathers, f"all-gathers in a data-parallel step: {gathers}"


def test_data2_step_reduces_the_gradient_and_gathers_nothing(runs):
    for rank in (0, 1):
        check_data_parallel_collectives(runs["data2"][rank]["step"])


def test_collective_check_refuses_a_replicated_unreduced_step(runs):
    broken = runs["data2"][0]["broken"]
    assert broken["collectives"] == []
    with pytest.raises(AssertionError, match="gradient all-reduce"):
        check_data_parallel_collectives(broken)


def test_fsdp2_step_scatters_gradients_and_gathers_parameters(runs):
    step = runs["fsdp2"][0]["step"]
    log, split = step["collectives"], _split_bytes(step)
    scattered = [c for c in log if c["op"] == "reduce_scatter_tensor"]
    gathered = [c for c in log if c["op"].startswith("all_gather")]
    assert sum(c["bytes"] for c in scattered) == split
    # each rank sends its half: the gathers rebuild exactly the split
    # parameters, flat, and gather nothing else
    assert all(c["op"] == "all_gather_into_tensor" and len(c["shape"]) == 1
               and c["group"] == 2 for c in gathered)
    assert 2 * sum(c["bytes"] for c in gathered) == split
    # the replicated leaves and the slices are averaged over the data
    # group (one rank here), the guard's flag and-ed over fsdp
    assert any(c["op"] == "all_reduce" and c["group"] == 1 for c in log)


# -- (e) multihost ------------------------------------------------------------

def test_multihost_at_world_1_returns_its_input(runs):
    got = runs["world1"]["multihost"]
    assert (got["count"], got["index"]) == (1, 0)
    assert got["arrays"]["x"].shape == (1, 2)
    assert got["mean"] == {"b": 0.0, "a": 0.0}
    assert got["records"] == [(0, 0)]
    arrays = {"x": np.arange(3)}
    assert multihost.allgather_arrays(arrays) is arrays


@pytest.mark.parametrize("rank", [0, 1])
def test_multihost_at_world_2(runs, rank):
    got = runs["data2"][rank]["multihost"]
    assert (got["count"], got["index"]) == (2, rank)
    np.testing.assert_array_equal(got["arrays"]["x"],
                                  [[0, 0], [1, 1], [1, 1]])
    np.testing.assert_array_equal(got["arrays"]["y"][0], [0, 0, 1])
    assert got["mean"] == {"a": 0.5, "b": 5.0}
    assert list(got["mean"]) == ["a", "b"]        # sorted keys
    assert got["records"] == [(0, 0), (1, 0), (1, 1)]


# -- (f) the detector step and dropout ----------------------------------------

def _check_det_against_world1(got: dict, ref: dict) -> None:
    for k, v in ref["metrics"].items():
        assert_close(got["metrics"][k], v, LOSS_TOL, k)
    assert ref["metrics"]["nonfinite_grads"] == 0.0
    for i, (a, b) in enumerate(zip(got["exp_avg"], ref["exp_avg"])):
        if b.any():
            assert_close(a.numpy(), b.numpy(), GRAD_TOL, f"exp_avg {i}")
    for key, b in ref["model"].items():
        a = got["model"][key]
        if key.endswith(("running_mean", "running_var")):
            assert_close(a.numpy(), b.numpy(), STATS_TOL, key)
        elif b.is_floating_point():
            assert float((a - b).abs().max()) <= 2 * LR + 1e-6 * float(
                b.abs().max()), key


@pytest.mark.parametrize("rank", [0, 1])
def test_det_step_through_shard_det_batch_matches_world1(runs, rank):
    _check_det_against_world1(runs["data2"][rank]["det"],
                              runs["world1"]["det"])


# -- the checks' own check: a planted fault turns them red ---------------------

@pytest.mark.parametrize("fault", pt.FAULTS)
def test_planted_fault_fails_the_data2_step_check(runs, fault):
    """Each fault a data-parallel step could carry (planted_fault: the
    BatchNorms on their rank's statistics, the losses on their rank's
    counts, no gradient reduction) fails (b)'s check on both ranks."""
    for rank in (0, 1):
        with pytest.raises(AssertionError):
            _check_step_against_world1(runs["data2"][rank][("step", fault)],
                                       runs["world1"]["step"], runs["names"])


@pytest.mark.parametrize("fault", DET_FAULTS)
def test_planted_fault_fails_the_det_step_check(runs, fault):
    for rank in (0, 1):
        with pytest.raises(AssertionError):
            _check_det_against_world1(runs["data2"][rank][("det", fault)],
                                      runs["world1"]["det"])


def test_dropout_ranks_draw_the_global_mask(runs):
    ref = runs["world1"]["masks"]
    got = torch.cat([runs["data2"][r]["masks"] for r in (0, 1)])
    assert 0 < int((ref == 0).sum()) < ref.numel()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_wait_limit_fails_a_stuck_rank():
    """utils/parallel_testing.py: wait_limit, the per-rank time limit of
    tools/parallel_check.py. A rank of a one-process gloo group that issues
    an all-reduce and then makes no progress ends with exit code 3 after
    the limit, naming its rank, where it was and the collective."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import time, torch, torch.distributed as dist\n"
        "from multimodal_gar_tpu_torch.utils.parallel_testing import (\n"
        "    note_progress, wait_limit)\n"
        f"dist.init_process_group('gloo', init_method='tcp://localhost:{port}',"
        " rank=0, world_size=1)\n"
        "with wait_limit(1.0, 3):\n"
        "    note_progress('micro-step 2')\n"
        "    dist.all_reduce(torch.ones(3))\n"
        "    time.sleep(60)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 3, run.stderr[-2000:]
    assert "rank 3: no progress" in run.stderr
    assert "micro-step 2" in run.stderr
    assert "all_reduce #1 of shape (3,)" in run.stderr
