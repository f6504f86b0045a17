"""The port's ``collate`` and ``DataPipeline`` against the JAX package's on
one on-disk synthetic JRDB: the same batches in the same order, every field
exactly equal (both read the same files through copies of the same numpy
code; nothing is computed in another order). With decode workers
(``num_workers > 0``, twins of tests/test_data_pipeline.py) the stream is
that of the serial path, byte for byte."""
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


def _assert_equal_batches(got: Batch, ref: Batch, what=""):
    for f in dataclasses.fields(Batch):
        g, r = getattr(got, f.name), getattr(ref, f.name)
        if r is None:
            assert g is None, f"{what}{f.name}"
            continue
        pairs = [(k, g[k], r[k]) for k in r] if isinstance(r, dict) \
            else [(f.name, g, r)]
        for name, gt, rt in pairs:
            assert gt.dtype == rt.dtype and torch.equal(gt, rt), \
                f"{what}{name}"


@pytest.fixture()
def pooled(datasets):
    pipe = DataPipeline(datasets[1], batch_size=2, shuffle=True, seed=7,
                        prefetch=1, num_workers=2)
    yield pipe
    pipe.close()


def test_two_workers_give_the_serial_stream_over_two_epochs(datasets,
                                                            pooled):
    """Byte-identical batches in the same order, against the port's serial
    path and (first epoch) against the JAX package's pipeline with its own
    decode pool."""
    ref_ds, got_ds = datasets
    serial = DataPipeline(got_ds, batch_size=2, shuffle=True, seed=7,
                          prefetch=0)
    for epoch in (0, 1):
        want = list(serial.epoch(epoch))
        got = list(pooled.epoch(epoch))
        assert len(got) == len(want) == len(got_ds) // 2
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_batches(g, w, f"epoch {epoch} batch {i}: ")
    jax_pipe = JaxPipeline(ref_ds, batch_size=2, shuffle=True, seed=7,
                           prefetch=1, num_workers=2)
    try:
        for i, (g, r) in enumerate(zip(pooled.epoch(0), jax_pipe.epoch(0))):
            _assert_same_batch(g, r, f"against JAX, batch {i}: ")
    finally:
        jax_pipe.close()


def test_workers_keep_the_padded_remainder_and_the_eig_fields(datasets):
    _, got_ds = datasets
    n = len(got_ds)
    size = 2 if n % 2 else 4
    kw = dict(batch_size=size, shuffle=False, drop_last=False,
              with_eig=True, eig_max_vecs=4)
    want = list(DataPipeline(got_ds, **kw).epoch(0))
    pipe = DataPipeline(got_ds, num_workers=2, **kw)
    try:
        got = list(pipe.epoch(0))
    finally:
        pipe.close()
    assert len(got) == len(want) == -(-n // size)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_equal_batches(g, w, f"batch {i}: ")
    assert not got[-1].person_valid[n % size:].any()


def test_an_abandoned_epoch_does_not_hang_the_next(datasets, pooled):
    _, got_ds = datasets
    it = pooled.epoch(2)
    first = next(it)
    it.close()                                          # abandon mid-stream
    again = list(pooled.epoch(2))
    assert len(again) == len(got_ds) // 2
    _assert_equal_batches(again[0], first, "after the abandoned epoch: ")


def test_workers_without_the_producer_thread_give_the_serial_stream(
        datasets):
    """prefetch=0 with num_workers=2 decodes in the workers all the same."""
    _, got_ds = datasets
    kw = dict(batch_size=2, shuffle=True, seed=7, prefetch=0)
    want = list(DataPipeline(got_ds, **kw).epoch(1))
    pipe = DataPipeline(got_ds, num_workers=2, **kw)
    try:
        sent = []
        imap = pipe._pool.imap
        pipe._pool.imap = lambda flat, epoch=0: (sent.extend(flat),
                                                 imap(flat, epoch=epoch))[1]
        got = list(pipe.epoch(1))
    finally:
        pipe.close()
    assert len(sent) == 2 * len(want)         # the pool decoded every sample
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_equal_batches(g, w, f"batch {i}: ")


class _Failing:
    """A dataset whose sample 2 cannot be decoded."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if i == 2:
            raise OSError("truncated frame 2")
        return self.inner[i]


def test_a_workers_decode_error_reaches_the_parent(datasets):
    pipe = DataPipeline(_Failing(datasets[1]), batch_size=1, shuffle=False,
                        num_workers=2)
    try:
        got = []
        with pytest.raises(RuntimeError, match="truncated frame 2"):
            for batch in pipe.epoch(0):
                got.append(batch)
        assert len(got) <= 2                  # nothing past the failure
    finally:
        pipe.close()


def test_close_ends_the_workers(datasets):
    pipe = DataPipeline(datasets[1], batch_size=1, num_workers=2)
    procs = list(pipe._pool._procs)
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    next(iter(pipe.epoch(0)))
    pipe.close()
    assert not any(p.is_alive() for p in procs)
    assert pipe._pool is None
    pipe.close()                                        # idempotent


def test_workers_never_import_torch_cuda_state(datasets):
    """A worker runs numpy code only: the decode loop's module imports
    neither torch nor anything of the port that does."""
    import ast
    import multimodal_gar_tpu_torch.data.decode_pool as decode_pool
    with open(decode_pool.__file__) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert imported <= {"__future__", "multiprocessing", "typing", "os",
                        "tempfile"}, imported
