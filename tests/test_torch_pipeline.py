"""The port's ``collate`` and ``DataPipeline`` against the JAX package's on
one on-disk synthetic JRDB: the same batches in the same order, every field
exactly equal (both read the same files through copies of the same numpy
code; nothing is computed in another order)."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from multimodal_gar_tpu.config import (DataConfig, PointCloudConfig,
                                       VoxelizationConfig)
from multimodal_gar_tpu.data.jrdb import JRDBActDataset as JaxDataset
from multimodal_gar_tpu.data.jrdb import collate as jax_collate
from multimodal_gar_tpu.data.pipeline import DataPipeline as JaxPipeline
from multimodal_gar_tpu.data.synthetic import write_synthetic_jrdb
from multimodal_gar_tpu_torch import config as port_config
from multimodal_gar_tpu_torch.data.jrdb import JRDBActDataset, collate
from multimodal_gar_tpu_torch.data.pipeline import DataPipeline
from multimodal_gar_tpu_torch.types import Batch

CAPS = (128, 128, 64, 32)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jrdb"))
    write_synthetic_jrdb(root, num_seqs=2, frames_per_seq=3,
                         people_per_frame=4, image_hw=(48, 80))
    kw = dict(root=root, image_size=(48, 80), num_frames=3, num_boxes=6)
    voxel = dict(voxel_size=(0.5, 0.5, 0.625), max_points_per_voxel=5,
                 max_voxels_train=128, max_voxels_test=128)
    pc = dict(num_points=96, range=(-6.0, -6.0, -2.0, 6.0, 6.0, 3.0))
    jax_cfg = DataConfig(point_cloud=PointCloudConfig(
        voxel=VoxelizationConfig(**voxel), **pc), **kw)
    cfg = port_config.DataConfig(point_cloud=port_config.PointCloudConfig(
        voxel=port_config.VoxelizationConfig(**voxel), **pc), **kw)
    ref = JaxDataset(jax_cfg, "train", training=True, rulebook_caps=CAPS)
    got = JRDBActDataset(cfg, "train", training=True, rulebook_caps=CAPS)
    assert len(ref) == len(got) >= 3
    return ref, got


def _assert_same_batch(got: Batch, ref, what=""):
    assert isinstance(got, Batch)
    for f in dataclasses.fields(Batch):
        g, r = getattr(got, f.name), getattr(ref, f.name)
        if r is None:
            assert g is None, f"{what}{f.name}"
            continue
        if isinstance(r, dict):
            assert list(g) == list(r), f"{what}{f.name}"
            pairs = [(f"{f.name}/{k}", g[k], r[k]) for k in r]
        else:
            pairs = [(f.name, g, r)]
        for name, gt, rt in pairs:
            assert isinstance(gt, torch.Tensor) and gt.device.type == "cpu"
            ra = np.asarray(rt)
            assert gt.numpy().dtype == ra.dtype, f"{what}{name}"
            np.testing.assert_array_equal(gt.numpy(), ra,
                                          err_msg=f"{what}{name}")


def test_samples_and_collate_match(datasets):
    ref_ds, got_ds = datasets
    ref = [ref_ds[i] for i in range(2)]
    got = [got_ds[i] for i in range(2)]
    for r, g in zip(ref, got):
        assert list(r) == list(g)
    batch = collate(got)
    _assert_same_batch(batch, jax_collate(ref), "collate: ")
    assert batch.images.shape == (2, 3, 48, 80, 3)
    assert batch.rulebook["win_0"].shape == (2, 128, 9)
    assert batch.rulebook["count_1"].shape == (2,)


@pytest.mark.parametrize("prefetch", [2, 0], ids=["producer_thread",
                                                  "inline"])
def test_two_shuffled_epochs_in_the_same_order(datasets, prefetch):
    ref_ds, got_ds = datasets
    kw = dict(batch_size=2, shuffle=True, seed=7, prefetch=prefetch)
    ref_pipe, got_pipe = JaxPipeline(ref_ds, **kw), DataPipeline(got_ds, **kw)
    assert got_pipe.steps_per_epoch() == ref_pipe.steps_per_epoch()
    orders = []
    for epoch in (0, 1):
        ref = list(ref_pipe.epoch(epoch))
        got = list(got_pipe.epoch(epoch))
        assert len(got) == len(ref) == len(ref_ds) // 2
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same_batch(g, r, f"epoch {epoch} batch {i}: ")
        orders.append(np.concatenate([g.frame_id.numpy() * 10
                                      + g.seq_id.numpy() for g in got]))
    assert not np.array_equal(orders[0], orders[1])     # reshuffled


def test_padded_remainder_batch(datasets):
    ref_ds, got_ds = datasets
    n = len(ref_ds)
    size = 2 if n % 2 else 4
    assert n % size
    kw = dict(batch_size=size, shuffle=False, drop_last=False)
    ref = list(JaxPipeline(ref_ds, **kw).epoch(0))
    got = list(DataPipeline(got_ds, **kw).epoch(0))
    assert len(got) == len(ref) == -(-n // size)
    for i, (g, r) in enumerate(zip(got, ref)):
        _assert_same_batch(g, r, f"batch {i}: ")
    last = got[-1]
    assert last.images.shape[0] == size
    assert not last.person_valid[n % size:].any()
    assert last.person_valid[:n % size].any()


def test_with_eig_fields(datasets):
    ref_ds, got_ds = datasets
    kw = dict(batch_size=2, shuffle=False, with_eig=True, eig_max_vecs=4)
    ref = list(JaxPipeline(ref_ds, **kw).epoch(0))
    got = list(DataPipeline(got_ds, **kw).epoch(0))
    for g, r in zip(got, ref):
        assert g.e_hat.shape == (2, 4, 6) and g.e_count.shape == (2,)
        assert g.e_hat.dtype == torch.float32
        assert g.e_count.dtype == torch.int32
        _assert_same_batch(g, r, "with_eig: ")
    assert any(int(g.e_count.sum()) > 0 for g in got)


def test_sharded_epochs_have_equal_lengths(datasets):
    ref_ds, got_ds = datasets
    for shard in (0, 1):
        kw = dict(batch_size=1, shuffle=True, seed=3, shard_index=shard,
                  shard_count=2)
        ref = list(JaxPipeline(ref_ds, **kw).epoch(0))
        got = list(DataPipeline(got_ds, **kw).epoch(0))
        assert len(got) == len(ref) == len(ref_ds) // 2
        for g, r in zip(got, ref):
            _assert_same_batch(g, r, f"shard {shard}: ")


def test_abandoned_epoch_leaves_no_producer_thread(datasets):
    _, got_ds = datasets
    before = set(threading.enumerate())
    pipe = DataPipeline(got_ds, batch_size=1, shuffle=False, prefetch=1)
    it = pipe.epoch(0)
    next(it)
    assert set(threading.enumerate()) - before          # a producer runs
    it.close()                                          # abandon the epoch
    leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not leaked, leaked
    assert len(list(pipe.epoch(1))) == len(got_ds)      # and the next works
    pipe.close()


def test_decode_pool_is_not_ported(datasets):
    with pytest.raises(NotImplementedError, match="num_workers"):
        DataPipeline(datasets[1], batch_size=1, num_workers=2)
