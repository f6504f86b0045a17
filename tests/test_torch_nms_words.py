"""The greedy NMS over suppression words (ops/boxes3d.py: nms_bev,
circle_nms; ops/kernels/nms_bev.py) against the full-matrix statement of
the same rule: the whole N x N IoU (or squared centre distance) matrix of
ops/boxes3d.py and a sequential sweep in descending score order. Exact keep
masks: both compute each pair's IoU with the same torch clip, the later box
clipped by the earlier one's edges."""
import numpy as np
import pytest
import torch

import multimodal_gar_tpu_torch.ops.boxes3d as pb3
from multimodal_gar_tpu_torch.ops.kernels import nms_bev as nw
from multimodal_gar_tpu_torch.utils import profiling


def _boxes(n, seed, spread=6.0):
    """(n, 7) float32 boxes in overlapping clusters, any yaw."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (max(n // 6, 1), 2))
    xy = centers[rng.integers(0, len(centers), n)] \
        + rng.normal(0, 0.6, (n, 2))
    z = rng.uniform(-1, 1, (n, 1))
    dims = rng.uniform(0.5, 4.0, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return torch.from_numpy(
        np.concatenate([xy, z, dims, yaw], -1).astype(np.float32))


def full_matrix_nms(boxes, scores, thr, valid, circle=False):
    """The rule stated on the whole matrix: in descending score order (a
    stable sort), box i is kept iff it is valid and no kept box j before it
    has IoU(i clipped by j) > thr (circle: squared centre distance <=
    thr)."""
    if circle:
        c = boxes[:, :2]
        hit = (((c[:, None] - c[None]) ** 2).sum(-1) <= thr).numpy()
    else:
        hit = (pb3.boxes_iou_bev(boxes, boxes) > thr).numpy()
    keep = np.zeros(len(boxes), bool)
    for i in torch.argsort(-scores, stable=True).tolist():
        keep[i] = bool(valid[i]) and not np.any(keep & hit[i])
    return keep


def _case(n, seed, ties=False):
    g = torch.Generator().manual_seed(seed)
    b = _boxes(n, seed, spread=max(2.0, n ** 0.5 / 2))
    if ties:
        scores = torch.randint(0, 4, (n,), generator=g).float()
    else:
        scores = torch.randperm(n, generator=g).float() / max(n, 1)
    valid = torch.rand(n, generator=g) > 0.1
    return b, scores, valid


@pytest.mark.parametrize("n", [1, 63, 64, 65, 700])
@pytest.mark.parametrize("thr", [0.1, 0.5])
def test_words_give_the_full_matrix_keep_mask(n, thr):
    b, scores, valid = _case(n, n)
    got = pb3.nms_bev(b, scores, thr, valid).numpy()
    want = full_matrix_nms(b, scores, thr, valid)
    np.testing.assert_array_equal(got, want)
    if n >= 63:
        assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize("fn", ["nms_bev", "circle_nms"])
def test_tied_scores_and_invalid_boxes(fn):
    """Equal scores keep the lower index first (the stable sort); an
    invalid box is never kept and suppresses nothing."""
    b, scores, valid = _case(150, 3, ties=True)
    thr = 2.0 if fn == "circle_nms" else 0.2
    got = getattr(pb3, fn)(b, scores, thr, valid).numpy()
    want = full_matrix_nms(b, scores, thr, valid, circle=fn == "circle_nms")
    np.testing.assert_array_equal(got, want)
    assert not got[~valid.numpy()].any()
    # an invalid top box suppresses nothing: its twin below it is kept
    b2 = torch.cat([b[:1], b[:1]])
    keep = pb3.nms_bev(b2, torch.tensor([1.0, 0.5]), 0.5,
                       torch.tensor([False, True])).numpy()
    np.testing.assert_array_equal(keep, [False, True])


def test_a_suppression_chain_across_word_boundaries():
    """Each box overlaps the next one only: kept, suppressed, kept, ...
    over 200 boxes, so the fate of each hangs on all before it."""
    n = 200
    b = torch.zeros((n, 7))
    b[:, 0] = torch.arange(n) * 0.9
    b[:, 3:6] = 1.0
    scores = torch.linspace(1, 0.5, n)
    got = pb3.nms_bev(b, scores, 0.05).numpy()
    np.testing.assert_array_equal(got, np.arange(n) % 2 == 0)
    np.testing.assert_array_equal(
        got, full_matrix_nms(b, scores, 0.05, torch.ones(n, dtype=bool)))


def test_words_hold_the_upper_triangle():
    """Bit j of row i is set only for j > i, where the full matrix has the
    pair above the threshold, and the counters count the clipped and the
    overlapping pairs."""
    n = 130
    b, scores, _ = _case(n, 9)
    order = torch.argsort(-scores, stable=True)
    s = b[order]
    words, counters = nw.bev_words(s, 0.3)
    assert words.shape == (n, 3) and words.dtype == torch.int64
    bits = ((words[:, :, None] >> torch.arange(64)) & 1).reshape(n, -1)[:, :n]
    iou = pb3.boxes_iou_bev(s, s).T          # [i, j]: j clipped by i
    want = (iou > 0.3) & torch.triu(torch.ones(n, n, dtype=bool), 1)
    assert torch.equal(bits.bool(), want)
    upper = torch.triu(torch.ones(n, n, dtype=bool), 1)
    assert int(counters[1]) == int(((iou > 0) & upper).sum())
    assert int(counters[1]) <= int(counters[0]) < int(upper.sum())


def test_counters_are_recorded_under_a_profiler_only():
    b, scores, valid = _case(100, 4)
    profiling.reset_counters()
    pb3.nms_bev(b, scores, 0.3, valid)
    assert profiling.counter_values() == {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        keep = pb3.nms_bev(b, scores, 0.3, valid)
        pb3.nms_bev(b, scores, 0.3, valid)
    got = profiling.counter_values()
    profiling.reset_counters()
    assert got["nms.boxes_in"] == 2 * int(valid.sum())
    assert got["nms.boxes_kept"] == 2 * int(keep.sum())
    assert got["nms.clip_pairs"] >= got["nms.overlap_pairs"] > 0
