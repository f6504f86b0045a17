"""The operation and byte counts behind ``mfu`` and the rooflines, against
hand counts at tiny shapes, an independent count of the convolutions the
port's I3D runs, and the stem's count in PERF.md."""
import itertools

import numpy as np
import pytest
import torch

import harness

mgar = harness.load_module("counts", "mgar.py")


def test_stem_at_mil3():
    c = mgar.stem_counts(15, 720, 1280)
    assert c["flop"] == pytest.approx(2.428e11, rel=1e-3)
    assert c["bytes"] == pytest.approx(6.40e8, rel=1e-2)


def test_stem_by_hand():
    c = mgar.stem_counts(1, 2, 2)
    assert c["flop"] == 2 * 3 * 64 * 343
    assert c["bytes"] == 4 * (12 + 343 * 3 * 64 + 128 + 64)


def test_i3d_against_the_convolutions_the_port_runs():
    """A FLOP counter over the port's eval I3D (cone cull on) at a small
    clip counts the same convolutions, but its stem as the s2d conv of a
    (7, 4, 4, 12, 64) kernel."""
    from torch.utils.flop_counter import FlopCounterMode
    from multimodal_gar_tpu_torch.models.i3d import InceptionI3d
    t, h, w = 15, 64, 96
    net = InceptionI3d("Mixed_4f", center_slice=True, device="cpu",
                       generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(1, t, h, w, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(x)
    to, ho, wo = -(-t // 2), -(-h // 2), -(-w // 2)
    s2d_stem = 2 * 7 * 4 * 4 * 12 * 64 * to * ho * wo
    want = mgar.i3d_flop(t, h, w) - mgar.stem_counts(t, h, w)["flop"] \
        + s2d_stem
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-6)


def _brute_taps(coords, shape, stride, pad):
    """Present taps of a 3^3 conv over the voxel set ``coords`` (zyx):
    submanifold where stride is 1, else onto the strided output grid."""
    cells = {tuple(c) for c in coords}
    if stride == 1:
        return sum((z + dz, y + dy, x + dx) in cells for z, y, x in cells
                   for dz, dy, dx in itertools.product((-1, 0, 1),
                                                       repeat=3))
    out = [(d + 2 * p - 3) // 2 + 1 for d, p in zip(shape, pad)]
    taps = 0
    for c in cells:
        choices = [[(v + p - k) // 2 for k in range(3)
                    if (v + p - k) % 2 == 0 and 0 <= (v + p - k) // 2 < o]
                   for v, p, o in zip(c, pad, out)]
        taps += len(choices[0]) * len(choices[1]) * len(choices[2])
    return taps


def test_sparse_taps_against_brute_force():
    rng = np.random.default_rng(0)
    shape = (9, 16, 16)
    pts = rng.integers(0, [9, 16, 16], size=(40, 3))
    coords = np.unique(pts, axis=0)
    m = 64
    c = np.full((1, m, 3), -1, np.int32)
    c[0, :len(coords)] = coords
    valid = np.zeros((1, m), bool)
    valid[0, :len(coords)] = True
    layers = mgar.sparse_layers(torch.from_numpy(c), torch.from_numpy(valid),
                                shape, (m, 1024, 1024, 1024), 4, "cpu")
    by = {L["layer"]: L for L in layers}
    assert by["conv_input"]["taps"] == _brute_taps(coords, shape, 1, None)
    assert by["conv1_0"]["taps"] == by["conv_input"]["taps"]
    assert by["conv2_down"]["taps"] == _brute_taps(coords, shape, 2,
                                                   (1, 1, 1))
    assert by["conv_input"]["c"] == 4 and by["conv_input"]["d"] == 16


def test_sparse_counts_by_hand():
    layers = [{"layer": "conv_input", "taps": 4, "rows_out": 2, "rows_in": 2,
               "c": 4, "d": 16},
              {"layer": "conv1_0", "taps": 4, "rows_out": 2, "rows_in": 2,
               "c": 16, "d": 16}]
    c = mgar.sparse_counts(layers, train=True)
    assert c["sparse_fwd_flop"] == 2 * 4 * 4 * 16 + 2 * 4 * 16 * 16
    assert c["sparse_dgrad_flop"] == 2 * 4 * 16 * 16     # not conv_input's
    assert c["sparse_wgrad_flop"] == c["sparse_fwd_flop"]
    assert c["sparse_fwd_bytes"] == 4 * (
        (2 * 4 + 27 * 4 * 16 + 2 * 16 + 2 * 9)
        + (2 * 16 + 27 * 16 * 16 + 2 * 16 + 2 * 9))
