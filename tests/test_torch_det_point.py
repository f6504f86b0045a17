"""The port's point operators and point modules against the JAX package's,
on seeded numpy inputs: farthest point sampling, ball query, three-NN
interpolation, grouping, RoI-aware and RoI-point pooling, vector pooling,
the point heads with their targets and losses, and PointNet++ MSG.

Selections (FPS, ball query, three-NN indices, RoI-point pooling, vector
pool counts) are held equal exactly on inputs without ties; values to
1e-4 of the largest reference value (float32 sums in other orders), the
modules against a float64 JAX run.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.ops import boxes3d as jbox
from multimodal_gar_tpu.ops import neighbor as jnb
from multimodal_gar_tpu.ops import sampling as jsamp
from multimodal_gar_tpu.ops.vector_pool import vector_pool as jvector_pool
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.ops import boxes3d as pbox
from multimodal_gar_tpu_torch.ops import neighbor as pnb
from multimodal_gar_tpu_torch.ops import sampling as psamp
from multimodal_gar_tpu_torch.ops.vector_pool import (
    vector_pool as pvector_pool)
from tests.test_torch_common import assert_close, random_variables, to_jax

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _points(seed, b, n, scale=5.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (b, n, 3)).astype(np.float32)


def test_fps_equals_jax_on_masked_sets():
    """Item 0 all valid; item 1 with a masked tail; item 2 with fewer valid
    points than samples (FPS then repeats them); item 3 with none."""
    xyz = _points(0, 4, 200)
    valid = np.ones((4, 200), bool)
    valid[1, 150:] = False
    valid[2, :] = False
    valid[2, [7, 50, 90]] = True
    valid[3, :] = False
    got = psamp.farthest_point_sampling(_t(xyz), 32, _t(valid)).numpy()
    for i in range(4):
        ref = np.asarray(jsamp.farthest_point_sampling(
            jnp.asarray(xyz[i]), 32, jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i], ref, f"item {i}")
    assert valid[1][got[1]].all() and got[2, 0] == 7
    assert set(got[2, :3]) == {7, 50, 90} and (got[3] == 0).all()
    # gather_points is the JAX gather
    np.testing.assert_array_equal(
        psamp.gather_points(_t(xyz), _t(got)).numpy()[1],
        np.asarray(jsamp.gather_points(jnp.asarray(xyz[1]),
                                       jnp.asarray(got[1]))))


def test_ball_query_equals_jax_with_an_empty_ball():
    xyz = _points(1, 2, 300)
    valid = np.ones((2, 300), bool)
    valid[1, ::3] = False
    queries = _points(2, 2, 40)
    queries[0, 5] = (50.0, 50.0, 50.0)            # no support near it
    idx, empty = pnb.ball_query(2.0, 8, _t(xyz), _t(queries), _t(valid))
    for i in range(2):
        ridx, rempty = jnb.ball_query(2.0, 8, jnp.asarray(xyz[i]),
                                      jnp.asarray(queries[i]),
                                      jnp.asarray(valid[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(empty[i].numpy(), np.asarray(rempty))
    assert bool(empty[0, 5]) and (idx[0, 5] == 0).all()
    # some balls overflow nsample, some are filled with their first hit
    hits = ((xyz[:, None] - queries[:, :, None]) ** 2).sum(-1) < 4.0
    count = (hits & valid[:, None]).sum(-1)
    assert (count > 8).any() and ((count > 0) & (count < 8)).any()
    grouped = pnb.grouping_operation(_t(xyz), idx)
    np.testing.assert_array_equal(
        grouped[1].numpy(), np.asarray(jnb.grouping_operation(
            jnp.asarray(xyz[1]), jnp.asarray(idx[1].numpy()))))


def test_three_nn_and_interpolate_equal_jax():
    unknown = _points(3, 2, 60)
    known = _points(4, 2, 20)
    kv = np.ones((2, 20), bool)
    kv[1, 10:] = False
    feats = np.random.default_rng(5).normal(size=(2, 20, 6)).astype(
        np.float32)
    dist, idx = pnb.three_nn(_t(unknown), _t(known), _t(kv))
    out = pnb.three_interpolate(_t(feats), idx, dist)
    for i in range(2):
        rd, ri = jnb.three_nn(jnp.asarray(unknown[i]), jnp.asarray(known[i]),
                              jnp.asarray(kv[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ri))
        assert_close(dist[i].numpy(), np.asarray(rd), TOL, "dist")
        assert_close(out[i].numpy(), np.asarray(jnb.three_interpolate(
            jnp.asarray(feats[i]), ri, rd)), TOL, "interpolate")


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, :3] = rng.uniform(-3, 3, (n, 3))
    b[:, 3:6] = rng.uniform(1.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[-1] = 0.0                                   # a padded box
    return b


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool3d_equals_jax(method):
    """Values equal to the JAX pool; the max's gradient is JAX's, on
    features with no tie in any cell (asserted)."""
    pts = _points(6, 2, 400, 4.0)
    feats = np.random.default_rng(7).normal(size=(2, 400, 5)).astype(
        np.float32)
    boxes = np.stack([_boxes(8, 6), _boxes(9, 6)])
    f = _t(feats).requires_grad_(True)
    got = pbox.roiaware_pool3d(_t(pts), f, _t(boxes), 4, method)
    w = np.random.default_rng(10).normal(size=tuple(got.shape))
    (got * _t(w).float()).sum().backward()
    for i in range(2):
        def fn(fe):
            return jbox.roiaware_pool3d(jnp.asarray(pts[i]), fe,
                                        jnp.asarray(boxes[i]), 4, method)
        ref, vjp = jax.vjp(fn, jnp.asarray(feats[i]))
        assert_close(got[i].detach().numpy(), np.asarray(ref), TOL, method)
        assert_close(f.grad[i].numpy(), np.asarray(vjp(
            jnp.asarray(w[i], jnp.float32))[0]), TOL, f"{method} grad")
    assert (got[:, -1] == 0).all()                 # the padded box
    if method == "max":
        from tests.test_torch_det_two_stage import assert_no_ties_in_cells
        assert_no_ties_in_cells(_t(pts), _t(feats), _t(boxes), 4)


def test_roipoint_pool3d_equals_jax_exactly():
    """First-k in-box points in point order, the empty slots cycling
    through the real ones, an empty box zeroed."""
    pts = _points(11, 2, 300, 4.0)
    feats = np.random.default_rng(12).normal(size=(2, 300, 3)).astype(
        np.float32)
    boxes = np.stack([_boxes(13, 5), _boxes(14, 5)])
    boxes[0, 0, :3] = 40.0                          # holds no point
    boxes[1, 1, 3:6] = 8.0                          # more than k points
    pooled, empty = pbox.roipoint_pool3d(_t(pts), _t(feats), _t(boxes), 16)
    for i in range(2):
        rp, re = jbox.roipoint_pool3d(jnp.asarray(pts[i]),
                                      jnp.asarray(feats[i]),
                                      jnp.asarray(boxes[i]), 16)
        np.testing.assert_array_equal(pooled[i].numpy(), np.asarray(rp))
        np.testing.assert_array_equal(empty[i].numpy(), np.asarray(re))
    assert bool(empty[0, 0]) and not bool(empty[1, 1])


def test_vector_pool_equals_jax():
    sup = _points(15, 2, 250, 3.0)
    feats = np.random.default_rng(16).normal(size=(2, 250, 4)).astype(
        np.float32)
    sv = np.ones((2, 250), bool)
    sv[0, 200:] = False
    q = _points(17, 2, 30, 3.0)
    pooled, counts = pvector_pool(_t(sup), _t(feats), _t(sv), _t(q), 1.2, 3)
    for i in range(2):
        rp, rc = jvector_pool(jnp.asarray(sup[i]), jnp.asarray(feats[i]),
                              jnp.asarray(sv[i]), jnp.asarray(q[i]), 1.2, 3)
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(rc))
        assert_close(pooled[i].numpy(), np.asarray(rp), TOL, "vector pool")
    assert (counts > 1).any() and (counts == 0).any()


def test_point_targets_and_losses_equal_jax():
    from multimodal_gar_tpu.detection import point_heads as jph
    from multimodal_gar_tpu.detection.box_coders import (
        PointResidualCoder as JCoder)
    from multimodal_gar_tpu_torch.detection import point_heads as pph
    from multimodal_gar_tpu_torch.detection.box_coders import (
        PointResidualCoder)
    pts = _points(18, 2, 200, 4.0)
    pv = np.ones((2, 200), bool)
    pv[1, 180:] = False
    gt = np.stack([_boxes(19, 4), _boxes(20, 4)])
    gtc = np.array([[1, 2, 3, 1], [2, 2, 1, 3]], np.int32)
    gtv = np.array([[True] * 3 + [False], [True] * 4])
    rng = np.random.default_rng(21)
    logits = rng.normal(size=(2, 200, 3)).astype(np.float32)
    box = rng.normal(size=(2, 200, 8)).astype(np.float32) * 0.1
    labels, gt_of, idx = pph.assign_point_targets(
        _t(pts), _t(pv), _t(gt), _t(gtc), _t(gtv))
    rl, rg, ri = jax.vmap(functools.partial(jph.assign_point_targets))(
        jnp.asarray(pts), jnp.asarray(pv), jnp.asarray(gt), jnp.asarray(gtc),
        jnp.asarray(gtv))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(gt_of.numpy(), np.asarray(rg))
    assert set(np.unique(labels.numpy())) >= {-1, 0}
    assert (labels.numpy() > 0).any()
    for k in (3, 1):
        assert_close(pph.point_cls_loss(_t(logits[..., :k]), labels, 3).item(),
                     np.asarray(jph.point_cls_loss(
                         jnp.asarray(logits[..., :k]), rl, 3)), TOL, "cls")
    assert_close(pph.point_box_loss(PointResidualCoder(), _t(box), _t(pts),
                                    labels, gt_of).item(),
                 np.asarray(jph.point_box_loss(
                     JCoder(), jnp.asarray(box), jnp.asarray(pts), rl, rg)),
                 TOL, "box")


def _module_parity(jmodule, port_module, args, n_out=None):
    """A JAX module (float64) against the port's: the eval outputs, and the
    training forward's outputs, gradients and new statistics under a fixed
    linear loss of the first output."""
    from tests.test_torch_det_common import expected_tensors
    variables = random_variables(jmodule, *args, train=False, seed=1)
    rng = np.random.default_rng(2)

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    def run(v, *a):
        ev = jmodule.apply(v, *a, train=False)

        def loss_fn(params):
            out, upd = jmodule.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, *a,
                train=True, mutable=["batch_stats"])
            return jnp.sum(first(out) * proj), (out, upd["batch_stats"])
        (_, (tr, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(v["params"])
        return ev, tr, grads, stats
    shape = jax.eval_shape(lambda v, *a: first(jmodule.apply(
        v, *a, train=False)), to_jax(variables), *args).shape
    proj = rng.normal(size=shape)
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
            else jnp.asarray(a), (to_jax(variables), args))
        ev, tr, grads, stats = jax.device_get(jax.jit(run)(wide[0],
                                                           *wide[1]))
    model = load_jax_variables(port_module, variables).eval()
    targs = [_t(np.asarray(a)) if a is not None else None for a in args]
    with torch.no_grad():
        got = model(*targs)
    assert_close(first(got).numpy(), np.asarray(first(ev)), TOL, "eval")
    model.train()
    got = model(*targs)
    assert_close(first(got).detach().numpy(), np.asarray(first(tr)), TOL,
                 "train")
    (first(got) * _t(proj).float()).sum().backward()
    want = expected_tensors(model, grads, stats)
    for name, p in model.named_parameters():
        assert_close(p.grad.numpy(), want[name].numpy(), TOL, f"grad {name}")
    for name, b in model.named_buffers():
        assert_close(b.numpy(), want[name].numpy(), TOL, f"new {name}")
    return got


def test_pointnet2_msg_matches_jax():
    """Two SA levels (one with two scales) and two FP levels; padded points
    give zero features."""
    from multimodal_gar_tpu.detection.pointnet2 import (
        PointNet2Config as JCfg, PointNet2MSG as JNet)
    from multimodal_gar_tpu_torch.detection.pointnet2 import (
        PointNet2Config, PointNet2MSG)
    kw = dict(npoints=(48, 16), radii=((1.0, 2.0), (2.5,)),
              nsamples=((8, 4), (8,)), sa_mlps=(((8, 8), (8,)), ((16,),)),
              fp_mlps=((16,), (16,)))
    rng = np.random.default_rng(22)
    pts = np.concatenate([_points(23, 2, 128), rng.uniform(
        0, 1, (2, 128, 1)).astype(np.float32)], -1)
    valid = np.ones((2, 128), bool)
    valid[1, 100:] = False
    pts[1, 100:] = 0.0
    got = _module_parity(JNet(JCfg(**kw)), PointNet2MSG(
        PointNet2Config(**kw), 1, device="cpu",
        generator=torch.Generator().manual_seed(0)), (pts, valid))
    assert (got[1, 100:] == 0).all()


@pytest.mark.parametrize("which", ["simple", "box"])
def test_point_heads_match_jax(which):
    from multimodal_gar_tpu.detection import point_heads as jph
    from multimodal_gar_tpu_torch.detection import point_heads as pph
    feats = np.random.default_rng(24).normal(size=(2, 50, 12)).astype(
        np.float32)
    kw = dict(cls_fc=(16, 8), reg_fc=(8,), num_class=3)

    class JHead(jph.PointHeadSimple if which == "simple"
                else jph.PointHeadBox):
        def __call__(self, x, train=False):
            out = super().__call__(x, train)
            return (out["point_cls_preds"] if which == "simple" else
                    jnp.concatenate([out["point_cls_preds"],
                                     out["point_box_preds"]], -1))

    class PHead(pph.PointHeadSimple if which == "simple"
                else pph.PointHeadBox):
        def forward(self, x):
            out = super().forward(x)
            return (out["point_cls_preds"] if which == "simple" else
                    torch.cat([out["point_cls_preds"],
                               out["point_box_preds"]], -1))
    _module_parity(JHead(jph.PointHeadConfig(**kw)),
                   PHead(12, pph.PointHeadConfig(**kw), device="cpu",
                         generator=torch.Generator().manual_seed(0)),
                   (feats,))
