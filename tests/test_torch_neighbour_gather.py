"""The grid pool's neighbour gather (ops/kernels/neighbour_gather.py) on
the CPU: its forward is advanced indexing bit for bit, its gradient is
advanced indexing's autograd to float32 round-off (the card's kernel is held
to the same plain version in tests/test_torch_cuda.py), its inverse map and
stats count what the kernel reads, and the grid pool's gradient through it
equals the gradient through the plain expression on both query paths.
"""
import dataclasses

import numpy as np
import pytest
import torch

from multimodal_gar_tpu_torch.models.roi_grid_pool import ROIGridPool
from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
from multimodal_gar_tpu_torch.ops.kernels import neighbour_gather as ng_mod
from multimodal_gar_tpu_torch.ops.kernels.neighbour_gather import (
    inverse_map, neighbour_gather, neighbour_gather_backward_plain)
from multimodal_gar_tpu_torch.utils.testing import (synthetic_batch_numpy,
                                                    tiny_config)

# (B, M, R, S, C, share kept, rows all on one voxel for the first R0 queries)
CASES = {
    "random": (1, 50, 40, 6, 32, 0.7, 0),
    "b2": (2, 30, 25, 5, 32, 0.6, 0),
    "width 7": (1, 40, 30, 4, 7, 0.7, 0),
    "all masked": (2, 20, 30, 4, 32, 0.0, 0),
    "one voxel, thousands kept": (1, 20, 600, 8, 32, 1.0, 500),
    "padded boxes on one voxel": (2, 64, 300, 16, 12, 0.4, 0),
}


def _case(name: str, seed: int = 0):
    """(f, rows, keep) of a case; in "padded boxes on one voxel" every
    masked query points at voxel 0, as an empty query's rows do."""
    b, m, r, s, c, share, r0 = CASES[name]
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.normal(size=(b, m, c)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, m, (b, r, s)))
    rows[:, :r0] = 3
    keep = torch.from_numpy(rng.random((b, r)) < share)
    if name == "padded boxes on one voxel":
        rows[~keep] = 0
    return f, rows, keep


def _plain(f, rows, keep):
    bidx = torch.arange(rows.shape[0])[:, None, None]
    return f[bidx, rows] * keep[..., None, None].to(f.dtype)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_is_advanced_indexing_bit_for_bit(name):
    f, rows, keep = _case(name)
    got = neighbour_gather(f.requires_grad_(), rows, keep)
    assert got.grad_fn is not None
    assert torch.equal(got, _plain(f, rows, keep))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_equals_advanced_indexing_autograd(name):
    """Each element within float32 summation round-off, 2 n eps sum|terms|
    for a row of n entries: both sides add in index_put_'s order, which
    runs in parallel on the CPU at these sizes and so varies by call."""
    f, rows, keep = _case(name)
    m = f.shape[1]
    w = torch.randn(rows.shape + (f.shape[-1],),
                    generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (neighbour_gather, _plain):
        leaf = f.clone().requires_grad_()
        (fn(leaf, rows, keep) * w).sum().backward()
        grads.append(leaf.grad)
    got, ref = grads
    n = max(int(inverse_map(rows, keep, m)[2].diff().max()), 1)
    mag = neighbour_gather_backward_plain(w.abs().double(), rows, keep, m)
    bound = 2 * n * torch.finfo(torch.float32).eps * mag
    assert ((got - ref).abs() <= bound).all()
    if not keep.any():
        assert not got.any()


def test_int32_rows_give_the_same_gather_and_gradient():
    f, rows, keep = _case("b2")
    outs = []
    for r in (rows, rows.to(torch.int32)):
        leaf = f.clone().requires_grad_()
        out = neighbour_gather(leaf, r, keep)
        out.sum().backward()
        outs.append((out, leaf.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_a_masked_entrys_non_finite_gradient_is_dropped():
    """The old graph sent 0 x inf = NaN into f's gradient; this backward
    never reads a masked entry."""
    f, rows, keep = _case("random")
    dout = torch.ones(rows.shape + (f.shape[-1],))
    q = int(torch.nonzero(~keep[0])[0, 0])
    dout[0, q] = float("inf")
    leaf = f.clone().requires_grad_()
    neighbour_gather(leaf, rows, keep).backward(dout)
    assert torch.isfinite(leaf.grad).all()


def test_without_a_gradient_the_gather_records_no_backward():
    f, rows, keep = _case("random")
    leaf = f.clone().requires_grad_()
    with torch.no_grad():
        out = neighbour_gather(leaf, rows, keep)
    assert out.grad_fn is None
    assert torch.equal(out, _plain(f, rows, keep))
    assert neighbour_gather(f, rows, keep).grad_fn is None


@pytest.mark.parametrize("name", ["b2", "one voxel, thousands kept",
                                  "padded boxes on one voxel"])
def test_inverse_map_lists_each_rows_kept_entries_in_flat_order(name):
    f, rows, keep = _case(name)
    b, m = f.shape[:2]
    s = rows.shape[2]
    skey, perm, off = inverse_map(rows, keep, m)
    assert skey.dtype == torch.int32 and off.dtype == torch.int32
    flat_keep = keep[:, :, None].expand(rows.shape).reshape(-1)
    flat_row = (rows + torch.arange(b)[:, None, None] * m).reshape(-1)
    assert int(off[-1]) == int(flat_keep.sum())
    for v in range(b * m):
        mine = perm[int(off[v]):int(off[v + 1])]
        want = torch.nonzero(flat_keep & (flat_row == v))[:, 0]
        assert torch.equal(mine, want), v
        assert (skey[int(off[v]):int(off[v + 1])] == v).all()
    assert (skey[int(off[-1]):] == b * m).all()
    assert perm.numel() == b * rows.shape[1] * s


def test_stats_count_kept_entries_and_the_longest_segment():
    ng_mod.reset_stats("cpu")
    want_kept, want_entries, want_longest = 0, 0, 0
    for name in ("b2", "one voxel, thousands kept", "all masked"):
        f, rows, keep = _case(name)
        leaf = f.clone().requires_grad_()
        neighbour_gather(leaf, rows, keep).sum().backward()
        b, m = f.shape[:2]
        kept = keep[:, :, None].expand(rows.shape)
        keys = (rows + torch.arange(b)[:, None, None] * m)[kept]
        want_kept += int(kept.sum())
        want_entries += rows.numel()
        if keys.numel():
            want_longest = max(want_longest,
                               int(torch.bincount(keys).max()))
    got = neighbour_gather.stats("cpu")
    assert got == {"entries": want_entries, "kept": want_kept,
                   "longest": want_longest}
    assert want_longest >= 500 * 8      # the thousands-kept voxel
    neighbour_gather.reset_stats("cpu")
    assert neighbour_gather.stats("cpu") == {"entries": 0, "kept": 0,
                                             "longest": 0}


@pytest.mark.parametrize("bad", ["keep dtype", "keep shape", "rows dtype",
                                 "batch"])
def test_malformed_inputs_raise(bad):
    f, rows, keep = _case("b2")
    if bad == "keep dtype":
        keep = keep.float()
    elif bad == "keep shape":
        keep = keep[:, :-1]
    elif bad == "rows dtype":
        rows = rows.float()
    else:
        f = f[:1]
    with pytest.raises((TypeError, ValueError)):
        neighbour_gather(f, rows, keep)


def _multiscale(fields, seed):
    """Random stage features on the rulebook's active sets, each needing a
    gradient."""
    rng = np.random.default_rng(seed)
    rb = fields["rulebook"]
    ms = {}
    for key, k, c in (("x_conv2", 1, 32), ("x_conv4", 3, 64)):
        coords = rb[f"coords_{k}"]
        valid = np.arange(coords.shape[1])[None] < rb[f"count_{k}"][:, None]
        f = rng.normal(size=coords.shape[:2] + (c,)).astype(np.float32)
        f *= valid[..., None]
        ms[key] = SparseTensor(torch.from_numpy(f).requires_grad_(),
                               torch.from_numpy(coords),
                               torch.from_numpy(valid), (0, 0, 0))
    return ms


@pytest.mark.parametrize("cull_k", [256, 0], ids=["culled", "dense"])
def test_grid_pool_gradient_through_both_query_paths(cull_k, monkeypatch):
    """A training ROIGridPool at tiny size, B = 2: the features' and
    weights' gradients through the gather's Function equal those through
    the plain expression, on the culled and on the dense query."""
    cfg = tiny_config()
    lcfg = dataclasses.replace(cfg.model.lidar, pool_cull_k=cull_k)
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    boxes = torch.from_numpy(fields["boxes3d"])
    valid = torch.from_numpy(fields["person_valid"])
    grads = []
    for plain in (False, True):
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr("multimodal_gar_tpu_torch.models.roi_grid_pool."
                           "neighbour_gather", _plain)
            mod = ROIGridPool(lcfg, cfg.data.point_cloud, device="cpu",
                              generator=torch.Generator().manual_seed(0))
            mod.train()
            ms = _multiscale(fields, 3)
            pooled, _ = mod(ms, boxes, valid)
            w = torch.randn(pooled.shape,
                            generator=torch.Generator().manual_seed(2))
            (pooled * w).sum().backward()
        grads.append({**{k: st.features.grad for k, st in ms.items()},
                      **{k: p.grad for k, p in mod.named_parameters()}})
    got, ref = grads
    assert got.keys() == ref.keys()
    for k, g in got.items():
        scale = max(float(ref[k].abs().max()), 1e-30)
        assert float((g - ref[k]).abs().max()) <= 1e-6 * scale, k
    assert float(got["x_conv2"].abs().max()) > 0


def test_the_timing_tool_takes_each_scales_gather_as_the_layer_calls_it():
    """tools/time_neighbour_gather.py: capture() records (M, C, rows, keep)
    of every grid-pool scale in one forward, the keep the layer passes, and
    leaves the layer's gather as it was."""
    from multimodal_gar_tpu_torch.models import roi_grid_pool
    from multimodal_gar_tpu_torch.models.lidar_backbone import LiDARBackbone
    from multimodal_gar_tpu_torch.tools.time_neighbour_gather import capture
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        people_on_voxels)
    cfg = tiny_config()
    model = LiDARBackbone(cfg.model.lidar, cfg.data.point_cloud,
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
    model.train()
    batch = batch_from_numpy(people_on_voxels(
        synthetic_batch_numpy(cfg, batch_size=1, seed=0, n_valid=2), cfg))
    taken = capture(model, (batch.voxels, batch.voxel_coords,
                            batch.voxel_num_points, batch.voxel_valid,
                            batch.boxes3d, batch.person_valid, batch.rulebook))
    assert roi_grid_pool.neighbour_gather is neighbour_gather
    assert len(taken) == len(cfg.model.lidar.pool_layers)
    r = cfg.data.num_boxes * cfg.model.lidar.grid_pool_size ** 3
    for (m, c, rows, keep), lc in zip(taken, cfg.model.lidar.pool_layers):
        assert c == lc.mlps[0] and rows.shape == (1, r, lc.nsample)
        assert keep.shape == (1, r) and keep.dtype == torch.bool
        assert 0 <= int(rows.min()) and int(rows.max()) < m
        # the padded boxes' queries are masked
        assert not keep[0, 2 * cfg.model.lidar.grid_pool_size ** 3:].any()
