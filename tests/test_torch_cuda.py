"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present. Run them
on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance 1e-4 of the largest plain value: float32 sums in another order.
The tiny train step compares the card with the CPU to 1e-4 per gradient,
as chip_smoke.py phase 4b does.
"""
import pytest
import torch

from multimodal_gar_tpu_torch.ops.kernels import sparse_wgrad as wgrad_mod
from multimodal_gar_tpu_torch.ops.kernels import subm_conv as subm_mod
from multimodal_gar_tpu_torch.ops.kernels.stem_conv import (stem_conv,
                                                            stem_conv_plain)
from multimodal_gar_tpu_torch.ops.kernels.row_gather import (row_gather,
                                                             row_gather_plain)
from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
    SUPPORTED, SUPPORTED_SHIFTED, window_conv, window_conv_plain,
    window_conv_shifted, window_conv_shifted_plain)
from multimodal_gar_tpu_torch.utils.testing import (ROW_GATHER_EDGE_CASES,
                                                    STEM_EDGE_SHAPES,
                                                    WGRAD_EDGE_CASES,
                                                    row_gather_edge_inputs,
                                                    stem_inputs_numpy,
                                                    wgrad_edge_inputs,
                                                    window_edge_cases)

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, ref):
    """max |got - ref| over max |ref|; 0 where both are all zero."""
    err = (got - ref).abs().max().item()
    return err / ref.abs().max().item() if err else 0.0


@pytest.mark.parametrize("shape,t_pad", [((1, 5, 19, 132, 12), (3, 3)),
                                         ((2, 6, 11, 70, 12), (2, 3))])
def test_stem_kernel_matches_plain(gen, shape, t_pad):
    xd, w2, scale, bias = (torch.from_numpy(a).cuda()
                           for a in stem_inputs_numpy(shape, 0))
    before = stem_conv.launches
    with torch.inference_mode():
        got = stem_conv(xd, w2, scale, bias, t_pad)
        ref = stem_conv_plain(xd, w2, scale, bias, t_pad)
    torch.cuda.synchronize()
    assert stem_conv.launches == before + 1
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("shape,t_pad", STEM_EDGE_SHAPES)
def test_stem_kernel_edge_shapes(gen, shape, t_pad):
    """An H_out the 4-row tile does not divide, a W edge tile, t_pad (3, 2)
    and (2, 3); the same inputs as tests/test_torch_stem_conv.py holds the
    plain version to XLA with."""
    xd, w2, scale, bias = (torch.from_numpy(a).cuda()
                           for a in stem_inputs_numpy(shape, 6))
    with torch.inference_mode():
        got = stem_conv(xd, w2, scale, bias, t_pad)
        ref = stem_conv_plain(xd, w2, scale, bias, t_pad)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL


def test_stem_kernel_refuses_a_w2_that_is_no_s2d_weight(gen):
    xd, w2, scale, bias = (torch.from_numpy(a).cuda()
                           for a in stem_inputs_numpy((1, 5, 9, 20, 12), 8))
    w2[3, 1, 3, 10, 2] = 0.5                  # kw = 3, ew = 1: 7x7 column 7
    before = stem_conv.launches
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="space-to-depth"):
        stem_conv(xd, w2, scale, bias)
    assert stem_conv.launches == before


_EDGE_NAMES = [case[0] for case in window_edge_cases()]


@pytest.mark.parametrize("name", _EDGE_NAMES)
def test_window_kernel_edge_cases(gen, name):
    """R below one tile, ragged 64- and 128-row tiles, stretches and whole
    launches whose taps are all absent, B = 2, R != M; the same inputs as
    tests/test_torch_window_conv.py holds the plain version to XLA with."""
    feats, win, w = (torch.from_numpy(a).cuda() for a in next(
        c[1:] for c in window_edge_cases() if c[0] == name))
    with torch.inference_mode():
        got = window_conv(feats, win, w)
        ref = window_conv_plain(feats, win, w)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL
    if name == "all absent":
        assert not got.any()


@pytest.mark.parametrize("c,d", sorted(SUPPORTED))
def test_window_kernel_matches_plain(gen, c, d):
    m, r = 1000, 700                          # R != M, several row blocks
    feats = torch.randn((2, m, c), device="cuda", generator=gen)
    pos = torch.randint(0, m, (2, r, 9), device="cuda", generator=gen,
                        dtype=torch.int32)
    sel = torch.randint(0, 64, (2, r, 9), device="cuda", generator=gen,
                        dtype=torch.int32)    # every slot code, 3 = absent
    win = pos | (sel << 20)
    w = torch.randn((27, c, d), device="cuda", generator=gen)
    before = window_conv.launches
    with torch.inference_mode():
        got = window_conv(feats, win, w)
        ref = window_conv_plain(feats, win, w)
    torch.cuda.synchronize()
    assert window_conv.launches == before + 1
    assert _rel(got, ref) <= TOL


def test_window_kernel_refuses_an_unbuilt_width(gen):
    with pytest.raises(ValueError, match="no \\(C, D\\)"):
        window_conv(torch.zeros((1, 8, 8), device="cuda"),
                    torch.zeros((1, 8, 9), dtype=torch.int32, device="cuda"),
                    torch.zeros((27, 8, 8), device="cuda"))


def _index_map(gen, b, r, m):
    """(b, r, 27) int32 rows in [0, m) with about a third absent (-1)."""
    idx = torch.randint(0, m, (b, r, 27), device="cuda", generator=gen,
                        dtype=torch.int32)
    absent = torch.rand((b, r, 27), device="cuda", generator=gen) < 0.35
    return torch.where(absent, -1, idx).to(torch.int32)


@pytest.mark.parametrize("c,d", sorted(subm_mod.SUPPORTED))
def test_subm_kernel_matches_plain(gen, c, d):
    m, r = 1000, 700                          # R != M, several row blocks
    table = torch.randn((2, m, c), device="cuda", generator=gen)
    idx = _index_map(gen, 2, r, m)
    w = torch.randn((27, c, d), device="cuda", generator=gen)
    before = subm_mod.subm_conv.launches
    with torch.inference_mode():
        got = subm_mod.subm_conv(table, idx, w)
        ref = subm_mod.subm_conv_plain(table, idx, w)
    torch.cuda.synchronize()
    assert subm_mod.subm_conv.launches == before + 1
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("c,d", sorted(wgrad_mod.SUPPORTED))
def test_wgrad_kernel_matches_plain(gen, c, d):
    m, r = 1000, 1300                         # rows span several chunks
    table = torch.randn((2, m, c), device="cuda", generator=gen)
    idx = _index_map(gen, 2, r, m)
    dout = torch.randn((2, r, d), device="cuda", generator=gen)
    before = wgrad_mod.sparse_wgrad.launches
    with torch.inference_mode():
        got = wgrad_mod.sparse_wgrad(table, idx, dout)
        ref = wgrad_mod.sparse_wgrad_plain(table, idx, dout)
        again = wgrad_mod.sparse_wgrad(table, idx, dout)
    torch.cuda.synchronize()
    assert wgrad_mod.sparse_wgrad.launches == before + 2
    assert _rel(got, ref) <= TOL
    assert torch.equal(got, again)            # no atomics: reproducible


@pytest.mark.parametrize("c", [5, 6, 7])
def test_input_layer_widths_run_the_padded_kernels(gen, c):
    """A first layer of 5 to 7 point features (nuScenes, Lyft, Waymo): K3,
    window_conv and K4 run their (8, 16) instances on the zero-padded table
    (ops/kernels/_pad.py), one launch each, against the plain versions at
    the unpadded width; K4's dW keeps the (27, C, 16) shape, twice with
    equal bits."""
    m, r = 1000, 1300
    table = torch.randn((2, m, c), device="cuda", generator=gen)
    idx = _index_map(gen, 2, r, m)
    w = torch.randn((27, c, 16), device="cuda", generator=gen)
    pos = torch.randint(0, m, (2, r, 9), device="cuda", generator=gen,
                        dtype=torch.int32)
    sel = torch.randint(0, 64, (2, r, 9), device="cuda", generator=gen,
                        dtype=torch.int32)
    win = pos | (sel << 20)
    dout = torch.randn((2, r, 16), device="cuda", generator=gen)
    counters = (subm_mod.subm_conv, window_conv, wgrad_mod.sparse_wgrad)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        k3 = subm_mod.subm_conv(table, idx, w)
        wc = window_conv(table, win, w)
        dw = wgrad_mod.sparse_wgrad(table, idx, dout)
        again = wgrad_mod.sparse_wgrad(table, idx, dout)
        refs = (subm_mod.subm_conv_plain(table, idx, w),
                window_conv_plain(table, win, w),
                wgrad_mod.sparse_wgrad_plain(table, idx, dout))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 2]
    assert dw.shape == (27, c, 16)
    for got, ref in zip((k3, wc, dw), refs):
        assert got.shape == ref.shape
        assert _rel(got, ref) <= TOL
    assert torch.equal(dw, again)


@pytest.mark.parametrize("c", [9, 10])
def test_input_widths_above_8_raise_naming_the_width(gen, c):
    """Widths above 8 that are no multiple of 4 (Waymo's one-hot
    timestamps over long sequences) have no instance."""
    table = torch.zeros((1, 8, c), device="cuda")
    idx = torch.zeros((1, 8, 27), dtype=torch.int32, device="cuda")
    win = torch.zeros((1, 8, 9), dtype=torch.int32, device="cuda")
    w = torch.zeros((27, c, 16), device="cuda")
    with pytest.raises(ValueError, match=f"input width {c}"):
        subm_mod.subm_conv(table, idx, w)
    with pytest.raises(ValueError, match=f"input width {c}"):
        window_conv(table, win, w)
    with pytest.raises(ValueError, match=f"input width {c}"):
        wgrad_mod.sparse_wgrad(table, idx, torch.zeros((1, 8, 16),
                                                        device="cuda"))


@pytest.mark.parametrize("name", sorted(WGRAD_EDGE_CASES))
def test_wgrad_kernel_edge_cases(gen, name):
    """Taps, stretches and whole launches with no pair present, the centre
    tap alone, every tap, one row, one row over a stretch, B = 2 with
    ragged tiles, the longer stretches of larger launches; the same
    inputs as tests/test_torch_sparse_wgrad.py holds the plain version to
    jax.vjp with. Twice, bit for bit: the sums run in a fixed order."""
    table, idx, dout = (torch.from_numpy(a).cuda()
                        for a in wgrad_edge_inputs(name))
    with torch.inference_mode():
        got = wgrad_mod.sparse_wgrad(table, idx, dout)
        ref = wgrad_mod.sparse_wgrad_plain(table, idx, dout)
        again = wgrad_mod.sparse_wgrad(table, idx, dout)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL
    assert torch.equal(got, again)
    absent = (idx < 0).all(dim=0).all(dim=0)          # taps no row has
    assert not got[absent].any()


def test_tiny_train_step_card_matches_cpu(gen):
    """One training forward and backward at tiny_config, card (kernels)
    against CPU (plain versions): same weights and batch, dropout off."""
    from multimodal_gar_tpu_torch.models import MGAR
    from multimodal_gar_tpu_torch.utils.testing import (
        BN_CANCELLED_BIASES, batch_from_numpy, condition_for_grad_parity_,
        prepare_grad_parity_, randomize_, synthetic_batch_numpy, tiny_config,
        train_loss_and_grads)
    cfg = tiny_config()
    fields = condition_for_grad_parity_(
        synthetic_batch_numpy(cfg, batch_size=2, seed=0))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = MGAR(cfg, device=dev,
                     generator=torch.Generator().manual_seed(0))
        randomize_(model, torch.Generator().manual_seed(1))
        loss, grads, stats = train_loss_and_grads(
            prepare_grad_parity_(model), batch_from_numpy(fields, dev))
        runs[dev] = (loss.cpu(), {k: v.cpu() for k, v in grads.items()},
                     {k: v.cpu() for k, v in stats.items()})
    (ref_loss, ref_g, ref_s), (loss, grads, stats) = runs["cpu"], runs["cuda"]
    assert _rel(loss, ref_loss) <= TOL
    for k, g in grads.items():
        if k in BN_CANCELLED_BIASES:          # rounding noise on both sides
            scale = ref_g[k.replace(".bias", ".weight")].abs().max()
            assert max(g.abs().max(), ref_g[k].abs().max()) <= 1e-3 * scale
        else:
            assert _rel(g, ref_g[k]) <= TOL, k
    for k, v in stats.items():
        assert _rel(v, ref_s[k]) <= TOL, k


@pytest.mark.parametrize("k", [1, 27])
@pytest.mark.parametrize("width", [32, 48, 128])
def test_row_gather_kernel_is_an_exact_copy(gen, k, width):
    m, r = 1000, 777                          # R not a multiple of 64
    tab = torch.randn((m, width), device="cuda", generator=gen)
    idx = torch.randint(0, m, (r, k), device="cuda", generator=gen,
                        dtype=torch.int32)
    before = row_gather.launches
    got = row_gather(tab, idx)
    again = row_gather(tab, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 2
    assert got.shape == (r, k * width)
    assert torch.equal(got, row_gather_plain(tab, idx))
    assert torch.equal(got, again)            # twice, bit-equal


@pytest.mark.parametrize("name", sorted(ROW_GATHER_EDGE_CASES))
def test_row_gather_kernel_edge_cases(gen, name):
    """A float4 count the per-thread unroll does not divide, width 4 (one
    float4 a row, 32 rows a warp), indices outside [0, M) in the last,
    partial block: exact, zeros for the rows out of range."""
    tab, idx, want = (torch.from_numpy(a).cuda()
                      for a in row_gather_edge_inputs(name))
    got = row_gather(tab, idx)
    again = row_gather(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


def test_row_gather_kernel_reads_out_of_range_rows_as_zero(gen):
    """The kernel cannot raise: an index outside [0, M) gives a zero row
    (the CPU path raises IndexError, tests/test_torch_probe_gather.py)."""
    m, width = 100, 32
    tab = torch.randn((m, width), device="cuda", generator=gen)
    idx = torch.tensor([[0, -1, 5], [m, 7, 2 ** 31 - 1]], dtype=torch.int32,
                       device="cuda")
    got = row_gather(tab, idx).reshape(2, 3, width)
    torch.cuda.synchronize()
    for (r, k), src in {(0, 0): 0, (0, 2): 5, (1, 1): 7}.items():
        assert torch.equal(got[r, k], tab[src])
    for r, k in ((0, 1), (1, 0), (1, 2)):
        assert not got[r, k].any()
    with pytest.raises(ValueError):
        row_gather(tab[:, :30], idx)          # width not a multiple of 4


@pytest.mark.parametrize("c,d", sorted(SUPPORTED_SHIFTED))
def test_shifted_window_kernel_matches_plain(gen, c, d):
    m, r = 1000, 777                          # R != M, a ragged last block
    wt = torch.randn((m, 3 * c), device="cuda", generator=gen)
    pos = torch.randint(0, m, (r, 9), device="cuda", generator=gen,
                        dtype=torch.int32)
    sel = torch.randint(0, 64, (r, 9), device="cuda", generator=gen,
                        dtype=torch.int32)    # every slot code, 3 = absent
    w = torch.randn((27, c, d), device="cuda", generator=gen)
    before = window_conv_shifted.launches
    with torch.inference_mode():
        got = window_conv_shifted(wt, pos, sel, w)
        ref = window_conv_shifted_plain(wt, pos, sel, w)
    torch.cuda.synchronize()
    assert window_conv_shifted.launches == before + 1
    assert _rel(got, ref) <= TOL
    with pytest.raises(ValueError, match="no \\(C, D\\)"):
        window_conv_shifted(wt[:, :3 * 4], pos, sel, w[:, :4, :16])


@pytest.mark.parametrize("max_voxels", [256, 4000])
def test_device_maps_on_the_card_equal_the_host_rulebook(gen, max_voxels):
    from multimodal_gar_tpu_torch.ops.device_rulebook import device_rulebook
    from multimodal_gar_tpu_torch.utils.testing import (synthetic_batch_numpy,
                                                        tiny_config)
    cfg = tiny_config(max_voxels=max_voxels)
    f = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    nx, ny, nz = cfg.data.point_cloud.grid_size
    maps = device_rulebook(torch.from_numpy(f["voxel_coords"]).cuda(),
                           torch.from_numpy(f["voxel_valid"]).cuda(),
                           (nz + 1, ny, nx),
                           cfg.model.lidar.max_voxels_per_stage)
    keys = [k for k in f["rulebook"] if k in maps]
    assert len(keys) == 13
    for k in keys:
        assert maps[k].is_cuda
        assert torch.equal(maps[k].cpu(), torch.from_numpy(f["rulebook"][k])), k


def test_dense_voxel_query_on_the_card_equals_its_cpu_run(gen):
    """The dense query on the card against the same call on the CPU:
    selected rows and empty flags equal where no candidate lies within
    1e-5 of the radius (the matmul's rounding differs between devices)."""
    from multimodal_gar_tpu_torch.ops.voxel import voxel_query
    m, r = 3000, 5000
    coords = torch.stack([torch.randint(0, s, (1, m), generator=gen,
                                        device="cuda")
                          for s in (4, 40, 40)], -1).to(torch.int32)
    coords = torch.unique(coords[0], dim=0)[None]
    valid = torch.rand(coords.shape[:2], generator=gen, device="cuda") < 0.9
    centers = (coords.flip(-1).float() + 0.5) * 0.5
    q_xyz = torch.rand((1, r, 3), generator=gen, device="cuda") \
        * torch.tensor([20.0, 20.0, 2.0], device="cuda")
    q_zyx = torch.floor(q_xyz / 0.5).to(torch.int32).flip(-1)
    q_valid = torch.rand((1, r), generator=gen, device="cuda") < 0.95
    args = (centers, coords, valid, q_xyz, q_zyx, q_valid, (1, 1, 1), 0.9, 8)
    idx, empty = voxel_query(*args, query_chunk=1024)
    ref_idx, ref_empty = voxel_query(
        *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args),
        query_chunk=1024)
    d = torch.cdist(q_xyz[0].double(), centers[0].double())
    edge = ((d - 0.9).abs() < 1e-5).any(-1).cpu()
    assert torch.equal(empty.cpu()[0][~edge], ref_empty[0][~edge])
    assert torch.equal(idx.cpu()[0][~edge], ref_idx[0][~edge])
    assert (~empty).any() and empty.any()


# ---------------------------------------------------------------------------
# the detector zoo on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,thr", [("nms_bev", 0.3), ("circle_nms", 2.0)])
def test_nms_on_the_card_equals_its_cpu_run(gen, fn, thr):
    """The rotated-IoU matrix and the greedy sweep on the card: the keep
    mask of its CPU run, on scores without ties."""
    import multimodal_gar_tpu_torch.ops.boxes3d as b3
    g = torch.Generator().manual_seed(1)
    n = 512
    boxes = torch.cat([torch.rand(n, 2, generator=g) * 30,
                       torch.rand(n, 1, generator=g),
                       0.5 + 3 * torch.rand(n, 3, generator=g),
                       6.3 * torch.rand(n, 1, generator=g)], 1)
    scores = torch.randperm(n, generator=g).float() / n
    valid = torch.rand(n, generator=g) > 0.05
    ref = getattr(b3, fn)(boxes, scores, thr, valid)
    got = getattr(b3, fn)(boxes.cuda(), scores.cuda(), thr, valid.cuda())
    assert torch.equal(got.cpu(), ref) and 0 < int(ref.sum()) < n


@pytest.mark.parametrize("kernel,stride,padding,cap", [
    ((3, 1, 1), (2, 1, 1), 0, 8000), ((3, 1, 1), (2, 1, 1), 0, 300)])
def test_strided_maps_on_the_card_equal_the_cpu(gen, kernel, stride,
                                                 padding, cap):
    """conv_out's active set and gather map built on the card: those of
    the CPU, cap overflow included."""
    from multimodal_gar_tpu_torch.ops.device_rulebook import (
        conv_out_shape, down_map, downsample_active_set)
    g = torch.Generator().manual_seed(2)
    shape = (11, 200, 176)
    keys = torch.stack([torch.randperm(shape[0] * shape[1] * shape[2],
                                       generator=g)[:4000]
                        for _ in range(2)])
    coords = torch.stack([keys // (shape[1] * shape[2]),
                          (keys // shape[2]) % shape[1], keys % shape[2]],
                         -1).int()
    valid = torch.ones(2, 4000, dtype=torch.bool)
    valid[1, 3000:] = False
    out_shape = conv_out_shape(shape, kernel, stride, padding)
    outs = []
    for dev in ("cpu", "cuda"):
        c, v = coords.to(dev), valid.to(dev)
        oc, ov, count, dropped = downsample_active_set(
            c, v, out_shape, stride, padding, cap, kernel)
        idx = down_map(c, v, shape, oc, ov, stride, padding, kernel)
        outs.append([t.cpu() for t in (oc, ov, count, dropped, idx)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    # each input site feeds at most 2 output sites: 8000 keeps them all
    assert (outs[0][3] > 0).any() == (cap < 8000)


def test_tiny_second_train_step_card_vs_cpu(gen):
    """A tiny SECOND's eval outputs, training loss, gradients and new
    statistics on the card (K3, K4) against its CPU run, to 1e-4."""
    from multimodal_gar_tpu_torch.detection import build_detector
    from multimodal_gar_tpu_torch.utils.testing import (tiny_det_batch,
                                                        tiny_detector_config)
    cfg = tiny_detector_config("SECOND")
    batch = tiny_det_batch(cfg)
    runs = []
    for dev in ("cpu", "cuda"):
        model = build_detector("SECOND", cfg, device=dev,
                               generator=torch.Generator().manual_seed(0))
        b = batch.to(dev)
        with torch.no_grad():
            preds = model.eval()(b)
        model.train()
        loss = model.loss(model(b), b)["loss"]
        loss.backward()
        runs.append((preds, loss, model))
    (p0, l0, m0), (p1, l1, m1) = runs
    for k in p0:
        assert _rel(p1[k].cpu(), p0[k]) <= TOL, k
    assert _rel(l1.detach().cpu(), l0.detach()) <= TOL
    grads = dict(m0.named_parameters())
    for k, p in m1.named_parameters():
        assert _rel(p.grad.cpu(), grads[k].grad) <= TOL, k
    stats = dict(m0.named_buffers())
    for k, t in m1.named_buffers():
        assert _rel(t.cpu(), stats[k]) <= TOL, k


def test_inverse_conv_maps_on_the_card(gen):
    """The inverse conv's maps (the strided layer's inverse map forward,
    its down map backward) built on the card equal the CPU's, with a cap
    that cuts sites off; K3 over them forward and as the data gradient
    matches its plain version."""
    from multimodal_gar_tpu_torch.ops.device_rulebook import device_rulebook
    from multimodal_gar_tpu_torch.ops.sparse_maps import (backbone_maps,
                                                          inverse_conv_maps)
    g = torch.Generator().manual_seed(1)
    shape = (21, 64, 64)
    keys = torch.stack([torch.randperm(21 * 64 * 64, generator=g)[:3000]
                        for _ in range(2)])              # unique voxels
    coords = torch.stack([keys // (64 * 64), keys // 64 % 64, keys % 64],
                         -1).to(torch.int32)
    valid = torch.ones((2, 3000), dtype=torch.bool)
    caps = (3000, 1500, 800, 400)
    maps = {}
    for dev in ("cpu", "cuda"):
        rb = device_rulebook(coords.to(dev), valid.to(dev), shape, caps)
        assert int(rb["dropped_1"].sum()) > 0
        maps[dev] = {k: inverse_conv_maps(v) for k, v in
                     backbone_maps(rb, key_sorted=False).items()
                     if k.startswith("down")}
    for k, inv in maps["cuda"].items():
        assert torch.equal(inv.fwd.cpu(), maps["cpu"][k].fwd), k
        assert torch.equal(inv.bwd.cpu(), maps["cpu"][k].bwd), k
    inv = maps["cuda"]["down_1"]
    coarse = torch.randn((2, inv.bwd.shape[1], 32), device="cuda",
                         generator=gen)
    w = torch.randn((27, 32, 16), device="cuda", generator=gen)
    with torch.inference_mode():
        got = subm_mod.subm_conv(coarse, inv.fwd, w)
        assert _rel(got, subm_mod.subm_conv_plain(coarse, inv.fwd, w)) <= TOL
        dout = torch.randn_like(got)
        wd = inv.dgrad_weights(w)
        got = subm_mod.subm_conv(dout, inv.bwd, wd)
        assert _rel(got, subm_mod.subm_conv_plain(dout, inv.bwd, wd)) <= TOL


def test_tiny_parta2_train_step_card_vs_cpu(gen, monkeypatch):
    """A tiny PartA2 (UNetV2 on K3 / K4, the inverse convs included): eval
    outputs, training losses, gradients and new statistics on the card
    against its CPU run, the card's RoI sampler fed the CPU's samples."""
    import multimodal_gar_tpu_torch.detection.roi_detectors as roi_det
    from multimodal_gar_tpu_torch.utils.testing import (
        tiny_det_batch, tiny_second_slice_detector)
    original, record, replay = roi_det.sample_rois_for_rcnn, [], []

    def sampler(generator, cfg, rois, *args):
        if rois.device.type == "cpu":
            record.append(original(generator, cfg, rois, *args))
            return record[-1]
        return {k: v.to(rois.device) for k, v in replay.pop(0).items()}
    monkeypatch.setattr(roi_det, "sample_rois_for_rcnn", sampler)
    runs = []
    for dev in ("cpu", "cuda"):
        model = tiny_second_slice_detector(
            "PartA2", device=dev, generator=torch.Generator().manual_seed(0))
        b = tiny_det_batch(model.cfg).to(dev)
        with torch.no_grad():
            preds = model.eval()(b)
        model.train()
        replay.extend(record)
        losses = model.loss(model(b), b)
        losses["loss"].backward()
        runs.append((preds, losses, model))
    (p0, l0, m0), (p1, l1, m1) = runs
    for k, v in p0.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            assert _rel(p1[k].cpu(), v) <= TOL, k
    for k, v in l0.items():
        assert _rel(l1[k].detach().cpu(), v.detach()) <= TOL, k
    grads = dict(m0.named_parameters())
    for k, p in m1.named_parameters():
        assert _rel(p.grad.cpu(), grads[k].grad) <= TOL, k
    stats = dict(m0.named_buffers())
    for k, t in m1.named_buffers():
        assert _rel(t.cpu(), stats[k]) <= TOL, k


def test_tiny_caddn_card_vs_cpu(gen):
    """The compact CaDDN at its parity-test size: frustum to voxel, BEV,
    head and the depth loss on the card against the CPU."""
    from multimodal_gar_tpu_torch.utils.testing import (card_vs_cpu,
                                                        tiny_caddn,
                                                        tiny_caddn_batch)

    def build(d):
        return tiny_caddn(device=d, generator=torch.Generator().manual_seed(0))
    card_vs_cpu(build, [tiny_caddn_batch(build("cpu").cfg)],
                lambda m, out, a: m.loss(out, a[0])["loss"])


def test_tiny_mppnet_card_vs_cpu(gen):
    """MPPNet at its parity-test size (4 frames in 2 groups)."""
    from multimodal_gar_tpu_torch.detection.mppnet import (MPPNetConfig,
                                                           MPPNetDetector)
    from multimodal_gar_tpu_torch.utils.testing import (TINY_MPPNET,
                                                        card_vs_cpu,
                                                        mppnet_inputs,
                                                        tiny_detector_config)
    x = mppnet_inputs()
    card_vs_cpu(
        lambda d: MPPNetDetector(tiny_detector_config("SECOND"),
                                 MPPNetConfig(**TINY_MPPNET), device=d,
                                 generator=torch.Generator().manual_seed(0)),
        [torch.from_numpy(x[k]) for k in ("fp", "pv", "rois", "rv")],
        lambda m, out, a: m.loss(out, *(torch.from_numpy(x[k]).to(
            a[0].device) for k in ("gt", "gtc", "gtv")))["loss"])


def test_tiny_pillar_res18_card_vs_cpu(gen):
    """PillarRes18Backbone to 256 channels at a tiny size: K3 at (256,
    256) forward and as the data gradient, K4 at (256, 256), against the
    CPU's plain versions through the whole backbone."""
    from multimodal_gar_tpu_torch.detection.extras import PillarRes18Backbone
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
    from multimodal_gar_tpu_torch.utils.testing import (card_vs_cpu,
                                                        sparse_input_numpy)
    f, c, v, shape = sparse_input_numpy(c=32)
    st = SparseTensor(torch.from_numpy(f).requires_grad_(),
                      torch.from_numpy(c), torch.from_numpy(v), shape)
    k3, k4 = subm_mod.subm_conv.launches, wgrad_mod.sparse_wgrad.launches
    card_vs_cpu(lambda d: PillarRes18Backbone(
        32, (32, 64, 128, 256), (60, 30, 12, 4), device=d,
        generator=torch.Generator().manual_seed(0)), [st],
        lambda m, out, a: sum(o.features.square().mean()
                              for o in out.values()))
    # 17 layers: an eval and a training forward, the data gradient of each
    assert subm_mod.subm_conv.launches == k3 + 3 * 17
    assert wgrad_mod.sparse_wgrad.launches == k4 + 17
