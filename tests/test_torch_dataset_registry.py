"""The port's dataset registry and the batches of every dataset against the
JAX package's, the test trees the port writes for the card, the point width
that reaches the detectors, and the sparse kernels' padded input layer.

- ``det_batches(with_indices=True, drop_last=False)``: the same order,
  shards and padding as the JAX package's at world 1 and 3, and the same
  DetBatches leaf for leaf, exactly; CPU tensors with ``device="cpu"``, the
  card by default.
- Each dataset's batches through the registry (KITTI, nuScenes, Waymo,
  Lyft, ONCE, PandaSet, Argoverse 2, custom) equal the JAX package's
  ``det_batch`` (for ONCE and custom, which have none, its
  ``assemble_det_batch``) leaf for leaf, exactly, on the trees of
  utils/testing.py: write_dataset_tree, which are the JAX tests' own.
- ``build_model`` / ``build_detector`` build every point detector for the
  point width of the config.
- K3, window_conv and K4 at C = 5, 6 and 7: the plain versions through the
  wrappers' zero padding to 8 (ops/kernels/_pad.py) compute what they
  compute at the unpadded width.
"""
import dataclasses
import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

import multimodal_gar_tpu.data.detbatch as jax_detbatch
import multimodal_gar_tpu.data.registry as jax_registry
import multimodal_gar_tpu_torch.data.registry as port_registry
from multimodal_gar_tpu_torch.config import Config
from multimodal_gar_tpu_torch.detection.detectors import DetBatch
from multimodal_gar_tpu_torch.models import build_model
from multimodal_gar_tpu_torch.models.registry import DETECTOR_NAMES
from multimodal_gar_tpu_torch.ops.kernels import _pad
from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
    sparse_wgrad_plain)
from multimodal_gar_tpu_torch.ops.kernels.subm_conv import subm_conv_plain
from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
    window_conv_plain)
from multimodal_gar_tpu_torch.utils.testing import (DATASET_TREES,
                                                    write_dataset_tree)
from tests.test_kitti import _make_kitti_tree
from tests.test_nuscenes import nusc_root  # noqa: F401
from tests.test_pandaset_argo2 import argo2_root, pandaset_root  # noqa: F401
from tests.test_waymo_lyft import lyft_root, waymo_root  # noqa: F401

VOXEL = (0.8, 0.8, 0.5)
BATCH_ARGS = dict(max_points=512, max_gt=8)


def same_batches(got: DetBatch, ref) -> None:
    """The port's DetBatch against the JAX package's, leaf for leaf."""
    for f in dataclasses.fields(got):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if r is None:
            assert g is None, f.name
        elif isinstance(r, dict):
            assert list(g) == list(r), f.name
            for k in r:
                assert g[k].device.type == "cpu"
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]),
                                              err_msg=f"{f.name}/{k}")
        else:
            assert g.device.type == "cpu", f.name
            assert g.numpy().dtype == np.asarray(r).dtype, f.name
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f.name)


def _kitti_frames(root, n: int = 7) -> None:
    """``n`` KITTI frames of 200 points (tests/test_kitti.py:
    test_dataset_registry's fixture, with more frames)."""
    base = os.path.join(root, "training")
    for sub in ("velodyne", "label_2", "calib"):
        os.makedirs(os.path.join(base, sub))
    rng = np.random.default_rng(0)
    for i in range(n):
        pts = rng.uniform(0, 30, (200, 4)).astype(np.float32)
        pts[:, 2] = rng.uniform(-1.5, 0.5, 200)
        pts.tofile(os.path.join(base, "velodyne", f"{i:06d}.bin"))
        with open(os.path.join(base, "calib", f"{i:06d}.txt"), "w") as f:
            f.write("P2: 700 0 600 0 0 700 200 0 0 0 1 0\n")
            f.write("R0_rect: 1 0 0 0 1 0 0 0 1\n")
            f.write("Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
        with open(os.path.join(base, "label_2", f"{i:06d}.txt"), "w") as f:
            f.write(f"Car 0 0 0 100 100 200 250 1.5 1.7 4.1 "
                    f"{i - 3.0} 1.6 8.0 0.2\n")


@pytest.mark.parametrize("world", [1, 3])
def test_det_batches_order_shards_and_padding_match_jax(world, tmp_path):
    _kitti_frames(tmp_path)
    jds = jax_registry.build_dataset("KittiDataset", root=str(tmp_path))
    pds = port_registry.build_dataset("KittiDataset", root=str(tmp_path))
    assert len(jds) == len(pds) == 7
    kw = dict(with_indices=True, drop_last=False, seed=1, epoch=2,
              world=world, **BATCH_ARGS)
    seen = []
    for rank in range(world):
        ref = list(jax_registry.det_batches(jds, 2, VOXEL, 64, rank=rank,
                                            **kw))
        got = list(port_registry.det_batches(pds, 2, VOXEL, 64, rank=rank,
                                             device="cpu", **kw))
        assert [i for i, _ in got] == [i for i, _ in ref]
        for (_, g), (_, r) in zip(got, ref):
            same_batches(g, r)
        seen += [i for idx, _ in got for i in idx]
    assert sorted(seen) == list(range(7))
    # the padded remainder repeats the last frame
    last_idx, last = got[-1]
    if len(last_idx) < 2:
        np.testing.assert_array_equal(last.voxels[0].numpy(),
                                      last.voxels[1].numpy())


def test_det_batches_put_batches_on_the_card_unless_asked(tmp_path):
    _kitti_frames(tmp_path, 2)
    ds = port_registry.build_dataset("KittiDataset", root=str(tmp_path))
    batch = next(port_registry.det_batches(ds, 1, VOXEL, 64, device="cpu",
                                           **BATCH_ARGS))
    assert all(t.device.type == "cpu" for t in
               [batch.voxels, batch.gt_boxes, *batch.rulebook.values()])
    batches = port_registry.det_batches(ds, 1, VOXEL, 64, **BATCH_ARGS)
    if torch.cuda.is_available():
        assert next(batches).voxels.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(batches)


JAX_FIXTURES = {"NuScenesDataset": "nusc_root", "WaymoDataset": "waymo_root",
                "LyftDataset": "lyft_root", "Argo2Dataset": "argo2_root",
                "PandasetDataset": "pandaset_root"}


def _same_file(a: str, b: str) -> None:
    if a.endswith(".pkl.gz"):
        import pandas as pd
        pd.testing.assert_frame_equal(pd.read_pickle(a), pd.read_pickle(b))
    elif a.endswith(".pkl"):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            ra, rb = pickle.load(fa), pickle.load(fb)
        _same_tree(ra, rb, a)
    else:
        assert filecmp.cmp(a, b, shallow=False), a


def _same_tree(a, b, where):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            _same_tree(x, y, where)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", sorted(DATASET_TREES))
def test_dataset_trees_are_the_jax_tests_trees(name, tmp_path, request):
    """utils/testing.py writes each JAX test's tree: the same files, the
    same bytes (pickles: the same contents). ONCE's and custom's trees are
    written inside their JAX tests, so they are held to what those tests
    assert."""
    import multimodal_gar_tpu.data.custom as jax_custom
    import multimodal_gar_tpu.data.once as jax_once
    port = tmp_path / "port"
    port.mkdir()
    kwargs = write_dataset_tree(name, port)
    assert kwargs["root"] == str(port)
    if name == "KittiDataset":
        ref = tmp_path / "jax"
        _make_kitti_tree(str(ref))
    elif name in JAX_FIXTURES:
        ref = request.getfixturevalue(JAX_FIXTURES[name])
    else:
        cls = (jax_once.OnceDataset if name == "ONCEDataset"
               else jax_custom.CustomDataset)
        kwargs.pop("root")
        fr = cls(str(port), **kwargs).frame(0)
        assert fr["gt_boxes"].shape == ((2, 7) if name == "ONCEDataset"
                                        else (1, 7))
        return
    files = [f for f in _files(ref) if not f.startswith("port")]
    assert _files(port) == files
    for f in files:
        _same_file(os.path.join(ref, f), os.path.join(port, f))


def _jax_batch(name, kwargs, indices):
    """The JAX package's DetBatch of ``indices`` of the tree: its
    ``det_batch``, or for ONCE and custom its ``assemble_det_batch``."""
    ds = jax_registry.build_dataset(name, **kwargs)
    if hasattr(ds, "det_batch"):
        return ds.det_batch(indices, VOXEL, 256, **BATCH_ARGS)
    return jax_detbatch.assemble_det_batch(ds, indices, VOXEL, 256,
                                           **BATCH_ARGS)


@pytest.mark.parametrize("name", sorted(DATASET_TREES))
def test_each_dataset_batches_through_the_registry_as_in_jax(name, tmp_path):
    kwargs = write_dataset_tree(name, tmp_path)
    ds = port_registry.build_dataset(name, **kwargs)
    got = list(port_registry.det_batches(
        ds, 2, VOXEL, 256, shuffle=False, drop_last=False, with_indices=True,
        device="cpu", **BATCH_ARGS))
    assert [i for idx, _ in got for i in idx] == list(range(len(ds)))
    for idx, batch in got:
        idx = idx + idx[-1:] * (2 - len(idx))
        same_batches(batch, _jax_batch(name, kwargs, idx))
        assert batch.voxel_valid.any()
    width = {"NuScenesDataset": 5, "LyftDataset": 5, "WaymoDataset": 5}
    assert batch.voxels.shape[-1] == width.get(name, 4)


# detectors whose input takes no point features: CaDDN reads images,
# MPPNet and MPPNetE2E refine given trajectories
NO_POINT_INPUT = ("CaDDN", "MPPNet", "MPPNetE2E")


def _config(num_point_features: int) -> Config:
    cfg = Config()
    pc = dataclasses.replace(
        cfg.data.point_cloud, range=(0.0, -8.0, -2.0, 16.0, 8.0, 2.0),
        num_point_features=num_point_features,
        voxel=dataclasses.replace(cfg.data.point_cloud.voxel,
                                  voxel_size=(0.25, 0.25, 0.125)))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, point_cloud=pc))


@pytest.mark.parametrize("name", sorted(DETECTOR_NAMES))
def test_build_model_builds_for_the_point_width(name):
    """At 5 point features every parameter that reads them is one row or
    column wider than at 4, and nothing else changes (flax infers the
    width from the batch)."""
    shapes = {}
    for width in (4, 5):
        model = build_model(_config(width), name, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        shapes[width] = {k: tuple(v.shape)
                         for k, v in model.state_dict().items()}
    assert shapes[4].keys() == shapes[5].keys()
    wider = {k for k in shapes[4] if shapes[4][k] != shapes[5][k]}
    for k in wider:
        diff = [b - a for a, b in zip(shapes[4][k], shapes[5][k])]
        assert sorted(diff)[-1] == 1 and sum(diff) == 1, (k, diff)
    assert bool(wider) == (name not in NO_POINT_INPUT), wider


def _sparse_inputs(c: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    m, r = 60, 50
    table = torch.randn((2, m, c), generator=g)
    idx = torch.randint(0, m, (2, r, 27), generator=g, dtype=torch.int32)
    idx = torch.where(torch.rand((2, r, 27), generator=g) < 0.4, -1, idx)
    pos = torch.randint(0, m, (2, r, 9), generator=g, dtype=torch.int32)
    sel = torch.randint(0, 64, (2, r, 9), generator=g, dtype=torch.int32)
    weights = torch.randn((27, c, 16), generator=g)
    dout = torch.randn((2, r, 16), generator=g)
    return table, idx.to(torch.int32), pos | (sel << 20), weights, dout


@pytest.mark.parametrize("kernel", ["subm_conv", "window_conv",
                                    "sparse_wgrad"])
@pytest.mark.parametrize("c", [5, 6, 7])
def test_padded_input_layer_computes_the_same(kernel, c):
    """The wrappers' padding to 8 around each kernel's plain version; the
    kernels themselves are held on the card (tests/test_torch_cuda.py,
    chip_smoke.py phase 13d). float32 sums with zero terms added in
    another order: 1e-6 of the largest value."""
    table, idx, win, weights, dout = _sparse_inputs(c, seed=c)
    seen = []

    def spy(plain):
        def launch(t, maps, other):
            seen.append(t.shape[-1])
            assert t.is_contiguous() and t.shape[-1] == 8
            if plain is not sparse_wgrad_plain:
                assert other.shape == (27, 8, 16)
                assert not other[:, c:].any()
            assert not t[..., c:].any()
            return plain(t, maps, other)
        return launch
    if kernel == "sparse_wgrad":
        ref = sparse_wgrad_plain(table, idx, dout)
        got = _pad.wgrad_on_padded_table(spy(sparse_wgrad_plain), table,
                                         idx, dout)
        assert got.shape == (27, c, 16) and got.is_contiguous()
    else:
        plain, maps = ((subm_conv_plain, idx) if kernel == "subm_conv"
                       else (window_conv_plain, win))
        ref = plain(table, maps, weights)
        got = _pad.conv_on_padded_table(spy(plain), table, maps, weights)
    assert seen == [8]
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    # widths the kernels run as they are reach them unpadded; 9 is padded
    # to the (12, 16) instance (tests/test_torch_input_widths.py)
    assert _pad.kernel_width(4) == 4 and _pad.kernel_width(12) == 12
    assert _pad.kernel_width(9) == 12
