"""The sparse kernels' input layer at every point width, and a Waymo tree of
three past frames (9 point features) through the registry into a
CenterPoint, against the JAX package.

- ops/kernels/_pad.py routes widths 1-16: K3 and window_conv run 1-3 on
  their (4, 16) instances (xyz-only points), 5-7 on (8, 16), 9-11 on
  (12, 16) and 13-15 on (16, 16), K4 runs 1-3 at 4, 5-7 at 8 and 9-15 at
  16; each route reaches an instance the CUDA wrappers list
  (``SUPPORTED``), on a zero-padded table, and computes what the plain
  version computes at the unpadded width (float32 sums with zero terms:
  1e-6 of the largest value). A width no route covers (17) raises in the
  wrapper, naming the width. The kernels themselves are held on the card
  (tests/test_torch_cuda.py, chip_smoke.py phases 3 and 14d).
- Waymo with ``sequence_offset`` (-3, 0) and one-hot timestamps (pcdet's
  multi-frame setting): 5 + 3 + 1 = 9 features. ``det_batches`` gives the
  JAX package's batches leaf for leaf, and a CenterPoint built for 9
  features runs its eval forward and ``predict`` on them as the float64
  JAX run does, to 1e-4 (tests/test_torch_det_common.py: jax_run).
"""
import numpy as np
import pytest
import torch

import multimodal_gar_tpu.data.registry as jax_registry
import multimodal_gar_tpu_torch.data.registry as port_registry
from multimodal_gar_tpu.detection import build_detector as jax_build
from multimodal_gar_tpu_torch.detection import build_detector
from multimodal_gar_tpu_torch.ops.kernels import _pad
from multimodal_gar_tpu_torch.ops.kernels import sparse_wgrad as wgrad_mod
from multimodal_gar_tpu_torch.ops.kernels import subm_conv as subm_mod
from multimodal_gar_tpu_torch.ops.kernels import window_conv as window_mod
from multimodal_gar_tpu_torch.utils.testing import (
    TINY_NUSCENES_RANGE, TINY_NUSCENES_VOXEL, nuscenes_centerpoint_config,
    write_dataset_tree)
from tests.test_torch_common import random_variables, to_jax
from tests.test_torch_dataset_registry import same_batches
from tests.test_torch_det_common import check_eval
from tests.test_torch_det_nuscenes import jax_cfg

CONV_ROUTE = {**{c: c for c in range(1, 18)}, 1: 4, 2: 4, 3: 4, 5: 8, 6: 8,
              7: 8, 9: 12, 10: 12, 11: 12, 13: 16, 14: 16, 15: 16}
WGRAD_ROUTE = {**{c: c for c in range(1, 18)}, 1: 4, 2: 4, 3: 4, 5: 8, 6: 8,
               7: 8, **{c: 16 for c in range(9, 16)}}


def _inputs(c: int):
    g = torch.Generator().manual_seed(c)
    m, r = 60, 50
    table = torch.randn((2, m, c), generator=g)
    idx = torch.randint(0, m, (2, r, 27), generator=g, dtype=torch.int32)
    idx = torch.where(torch.rand((2, r, 27), generator=g) < 0.4, -1, idx)
    pos = torch.randint(0, m, (2, r, 9), generator=g, dtype=torch.int32)
    sel = torch.randint(0, 64, (2, r, 9), generator=g, dtype=torch.int32)
    weights = torch.randn((27, c, 16), generator=g)
    dout = torch.randn((2, r, 16), generator=g)
    return table, idx.to(torch.int32), pos | (sel << 20), weights, dout


def _spy(supported, plain, c, width, seen):
    """A launch that checks what the route hands the kernel, then runs the
    plain version at the kernel's width."""
    def launch(t, maps, other):
        seen.append(t.shape[-1])
        assert (t.shape[-1], 16) in supported
        assert t.is_contiguous() and t.shape[-1] == width
        assert not t[..., c:].any()
        if other.ndim == 3 and other.shape[0] == 27:      # the weights
            assert other.shape == (27, width, 16)
            assert not other[:, c:].any()
        return plain(t, maps, other)
    return launch


@pytest.mark.parametrize("c", range(1, 18))
def test_each_input_width_takes_its_route(c):
    table, idx, win, weights, dout = _inputs(c)
    assert _pad.kernel_width(c) == CONV_ROUTE[c]
    assert _pad.wgrad_width(c) == WGRAD_ROUTE[c]
    convs = [(subm_mod, subm_mod.subm_conv_plain, idx),
             (window_mod, window_mod.window_conv_plain, win)]
    for mod, plain, maps in convs:
        if (CONV_ROUTE[c], 16) not in mod.SUPPORTED:
            assert c > 16
            with pytest.raises(ValueError, match=f"input width {c}\\)"):
                _pad.conv_on_padded_table(mod._launch, table, maps, weights)
            continue
        seen = []
        got = _pad.conv_on_padded_table(
            _spy(mod.SUPPORTED, plain, c, CONV_ROUTE[c], seen), table, maps,
            weights)
        ref = plain(table, maps, weights)
        assert seen == [CONV_ROUTE[c]] and got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))
    if (WGRAD_ROUTE[c], 16) not in wgrad_mod.SUPPORTED:
        assert c > 16
        with pytest.raises(ValueError, match=f"input width {c}\\)"):
            _pad.wgrad_on_padded_table(wgrad_mod._launch, table, idx, dout)
        return
    seen = []
    got = _pad.wgrad_on_padded_table(
        _spy(wgrad_mod.SUPPORTED, wgrad_mod.sparse_wgrad_plain, c,
             WGRAD_ROUTE[c], seen), table, idx, dout)
    ref = wgrad_mod.sparse_wgrad_plain(table, idx, dout)
    assert seen == [WGRAD_ROUTE[c]]
    assert got.shape == (27, c, 16) and got.is_contiguous()
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.fixture(scope="module")
def waymo9(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo9")
    kwargs = dict(write_dataset_tree("WaymoDataset", root),
                  sequence_offset=(-3, 0), onehot_timestamp=True,
                  point_cloud_range=TINY_NUSCENES_RANGE)
    jds = jax_registry.build_dataset("WaymoDataset", **kwargs)
    pds = port_registry.build_dataset("WaymoDataset", **kwargs)
    batches = list(port_registry.det_batches(
        pds, 2, TINY_NUSCENES_VOXEL, 256, shuffle=False, drop_last=False,
        with_indices=True, device="cpu"))
    return dict(jds=jds, pds=pds, batches=batches)


def test_waymo_three_past_frames_batch_as_in_jax(waymo9):
    assert waymo9["pds"].num_point_features == 9
    got = waymo9["batches"]
    assert [i for idx, _ in got for i in idx] == [0, 1, 2]
    for idx, batch in got:
        idx = idx + idx[-1:] * (2 - len(idx))
        same_batches(batch, waymo9["jds"].det_batch(
            idx, TINY_NUSCENES_VOXEL, 256))
        assert batch.voxels.shape[-1] == 9
    # the last frame holds points of all four frames, one-hot in 5..8 (a
    # voxel's unused point slots are zero)
    batch = got[1][1]
    slots = torch.arange(batch.voxels.shape[2])
    used = (slots < batch.voxel_num_points[0, :, None]) \
        & batch.voxel_valid[0, :, None]
    onehot = batch.voxels[0, ..., 5:][used]
    assert set(np.unique(onehot.sum(-1).numpy())) == {1.0}
    assert (onehot.sum(0) > 0).all()


def test_centerpoint_at_9_features_matches_jax(waymo9):
    from tests.test_torch_det_common import jax_run
    jb = waymo9["jds"].det_batch([2, 2], TINY_NUSCENES_VOXEL, 256)
    cfg = nuscenes_centerpoint_config(tiny=True)
    jmodel = jax_build("CenterPoint", jax_cfg(cfg))
    variables = random_variables(jmodel, jb, train=False, seed=1)
    setup = dict(jb=jb, variables=variables,
                 ref=jax_run(jmodel, to_jax(variables), jb),
                 model_fn=lambda: build_detector(
                     "CenterPoint", cfg, in_channels=9, device="cpu"))
    model = setup["model_fn"]()
    assert model.trunk.backbone_3d.conv_input.conv.weight.shape[:2] == (27, 9)
    preds = check_eval(setup, "Waymo CenterPoint at 9 features")
    assert preds["hm"].shape[-1] == 10
