"""The port's MPPNet and MPPNetE2E (detection/mppnet.py) against the JAX
package's at a tiny config of 4 frames in 2 groups (so the group fusion,
both kinds of encoder layer and the inter-group cross-attention run):
the eval outputs and ``predict`` with the proposals' labels, the training
forward, losses, gradients and new statistics of the offline detector to
1e-4 against one float64 JAX run; the E2E detector's offline step and an
online step on its bank (the roll, ``memory_valid``, unwritten slots
repeating the current frame); ``generate_trajectory`` exactly.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.detection import mppnet as jax_mppnet
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.detection import mppnet
from multimodal_gar_tpu_torch.utils.testing import (TINY_MPPNET as MP,
                                                    mppnet_inputs)
from tests.test_detection import tiny_voxel_cfg
from tests.test_torch_common import assert_close, random_variables, to_jax
from tests.test_torch_det_common import (NOISE_TOL, compare_predict,
                                         compare_tree, expected_tensors,
                                         port_cfg)

TOL = 1e-4
# biases whose gradient is zero in exact arithmetic, rounding noise on
# both sides: the geometry MLP's last one reaches the loss only through the
# pool's bias-free Linear and its training BatchNorm, which subtracts it
# again (the rows outside the statistics are zeroed after the pool); a
# mixer's last one adds the same value to every channel of a grid row,
# which the LayerNorm over the channels subtracts again; an attention's key
# bias adds the same logit to every key of a query, which the softmax
# cancels
CANCELLED = re.compile(r"head\.(up_dim_geometry|enc\d+\.mixer\.mix_[xyz])"
                       r"\.fc2\.bias|head\.enc\d+\.(token_att|cross\d+)"
                       r"\.key\.bias")


def _t(a):
    return torch.from_numpy(np.array(a))


def _wide(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module")
def offline():
    """The offline detector: eval outputs and predict, the training
    forward, losses, gradients and statistics in one float64 JAX jit."""
    cfg = tiny_voxel_cfg("SECOND")
    jm = jax_mppnet.MPPNetDetector(cfg, jax_mppnet.MPPNetConfig(**MP))
    x = mppnet_inputs()
    args = tuple(jnp.asarray(x[k]) for k in ("fp", "pv", "rois", "rv", "tv"))
    variables = random_variables(jm, *args[:4], traj_valid=args[4], seed=1)

    def run(variables, fp, pv, rois, rv, tv, gt, gtc, gtv, labels):
        ev = jm.apply(variables, fp, pv, rois, rv, traj_valid=tv)
        out = jm.predict(dict(ev, roi_labels=labels))

        def loss_fn(params):
            preds, upd = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                fp, pv, rois, rv, traj_valid=tv, train=True,
                mutable=["batch_stats"])
            losses = jm.loss(preds, gt, gtc, gtv)
            return losses["loss"], (preds, losses, upd["batch_stats"])
        (_, (tr, losses, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return ev, out, tr, losses, grads, stats

    with jax.enable_x64(True):
        ref = jax.device_get(jax.jit(run)(
            _wide(to_jax(variables)), *_wide(args),
            *_wide(tuple(jnp.asarray(x[k]) for k in ("gt", "gtc", "gtv"))),
            jnp.asarray(x["labels"])))
    return dict(cfg=port_cfg(cfg), x=x, variables=variables, ref=ref)


def _port(cls, s):
    model = cls(s["cfg"], mppnet.MPPNetConfig(**MP), device="cpu",
                generator=torch.Generator().manual_seed(0))
    return load_jax_variables(model, s["variables"])


def _call_args(x):
    return (_t(x["fp"]), _t(x["pv"]), _t(x["rois"]), _t(x["rv"]))


def test_mppnet_eval_and_predict_match_jax(offline):
    s = offline
    ev, out_ref = s["ref"][:2]
    model = _port(mppnet.MPPNetDetector, s).eval()
    with torch.no_grad():
        preds = model(*_call_args(s["x"]), traj_valid=_t(s["x"]["tv"]))
        out = model.predict(dict(preds, roi_labels=_t(s["x"]["labels"])))
    compare_tree(preds, ev, "MPPNet eval")
    compare_predict(out, out_ref, "MPPNet predict")
    assert out["valid"].any()
    # the labels ride with the proposals
    v = out["valid"]
    assert set(out["labels"][v].tolist()) <= set(s["x"]["labels"].ravel())


def test_mppnet_trains_as_jax(offline):
    s = offline
    _, _, tr, losses_ref, grads, stats = s["ref"]
    model = _port(mppnet.MPPNetDetector, s).train()
    x = s["x"]
    preds = model(*_call_args(x), traj_valid=_t(x["tv"]))
    compare_tree({k: v for k, v in preds.items() if k in tr}, tr,
                 "MPPNet train")
    losses = model.loss(preds, _t(x["gt"]), _t(x["gtc"]), _t(x["gtv"]))
    assert set(losses) == set(losses_ref)
    for k, v in losses_ref.items():
        assert_close(losses[k].detach().numpy(), v, TOL, f"loss {k}")
    losses["loss"].backward()
    want = expected_tensors(model, grads, stats)
    for name, buf in model.named_buffers():
        assert_close(buf.numpy(), want[name].numpy(), TOL, f"new {name}")
    largest = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        if CANCELLED.fullmatch(name):
            for side in (p.grad, want[name]):
                assert float(side.abs().max()) <= NOISE_TOL * largest, name
            continue
        assert_close(p.grad.numpy(), want[name].numpy(), TOL,
                     f"grad {name}")


def test_mppnet_e2e_offline_and_online_match_jax(offline):
    """The E2E detector's offline step (a cold bank: every slot unwritten)
    and an online step on the bank it returns (only the current frame's
    points; the bank rolls by one, memory_valid with it)."""
    s = offline
    x = s["x"]
    cfg = tiny_voxel_cfg("SECOND")
    jm = jax_mppnet.MPPNetE2EDetector(cfg, jax_mppnet.MPPNetConfig(**MP))
    fp, pv, rois, rv = (jnp.asarray(x[k]) for k in ("fp", "pv", "rois", "rv"))

    def run(variables):
        out1 = jm.apply(variables, fp, pv, rois, rv)
        out2 = jm.apply(variables, fp[:, :1], pv[:, :1], rois, rv,
                        memory=out1["memory"],
                        memory_valid=out1["memory_valid"])
        return out1, out2
    ref1, ref2 = jax.device_get(jax.jit(run)(to_jax(s["variables"])))
    model = _port(mppnet.MPPNetE2EDetector, s).eval()
    args = _call_args(x)
    with torch.no_grad():
        out1 = model(*args)
        out2 = model(args[0][:, :1], args[1][:, :1], args[2], args[3],
                     memory=out1["memory"],
                     memory_valid=out1["memory_valid"])
    compare_tree(out1, ref1, "E2E offline")
    compare_tree(out2, ref2, "E2E online")
    # the roll: the newest slot is this step's, the old newest moves back
    assert torch.equal(out2["memory"][:, 1], out1["memory"][:, 0])
    assert torch.equal(out1["memory"][:, 0], out1["geo_memory_out"])
    assert out1["memory_valid"][:, 0].tolist() == x["rv"].tolist()
    assert not out1["memory_valid"][:, 1:].any()
    assert torch.equal(out2["memory_valid"][:, 1], out1["memory_valid"][:, 0])


def test_generate_trajectory_matches_jax_exactly():
    """Velocity-carrying boxes (C = 9) over 3 previous frames of proposals:
    some linked (IoU >= 0.5, the best-IoU proposal), some not (the entry
    keeps the current box, the frame invalid), ties to the first index."""
    rng = np.random.default_rng(5)
    r, p = 6, 7                     # p - 1 proposals near the boxes
    cur = np.zeros((r, 9), np.float32)
    cur[:, 0] = rng.uniform(0, 40, r)
    cur[:, 1] = rng.uniform(-20, 20, r)
    cur[:, 3:6] = rng.uniform(1.5, 4.5, (r, 3))
    cur[:, 6] = rng.uniform(-np.pi, np.pi, r)
    cur[:, 7:9] = rng.normal(0, 0.3, (r, 2))
    prev = np.repeat(cur[None], 3, 0)
    prev = np.concatenate([prev, prev[:, :1]], 1)
    prev[..., :2] += rng.normal(0, 0.25, (3, p, 2))
    prev[:, -1] = prev[:, 0]                        # a duplicate: a tie
    prev[1, 2, :2] += 30.0                          # no partner in frame 2
    tj, vj = jax_mppnet.generate_trajectory(jnp.asarray(cur),
                                            jnp.asarray(prev))
    tp, vp = mppnet.generate_trajectory(_t(cur), _t(prev))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    assert np.asarray(vj).any() and not np.asarray(vj).all()


def test_mppnet_exports_the_jax_tree(offline):
    """convert.py's export_variables gives back the JAX package's variable
    tree of MPPNet, the attention kernels in flax's (D, H, D / H) and
    (H, D / H, D) layouts and the group tokens included."""
    from flax.traverse_util import flatten_dict
    from multimodal_gar_tpu_torch.convert import export_variables
    s = offline
    got = flatten_dict(export_variables(_port(mppnet.MPPNetDetector, s)))
    want = {tuple(p for p in k if p != "BatchNorm_0"): v
            for k, v in flatten_dict(s["variables"]).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
