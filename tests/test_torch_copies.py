"""The port's own copies of the JAX package's framework-neutral modules
(config, data/rulebook + native, data/voxelizer, data/pointcloud,
data/synthetic, data/decode_pool, eval/jrdb_eval, eval/ap, utils/metrics)
against the
originals on seeded numpy inputs. The copies compute the same thing, so
every comparison is exact equality."""
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

import multimodal_gar_tpu.config as jax_config
import multimodal_gar_tpu.data.decode_pool as jax_decode_pool
import multimodal_gar_tpu.data.pointcloud as jax_pointcloud
import multimodal_gar_tpu.data.rulebook as jax_rulebook
import multimodal_gar_tpu.data.synthetic as jax_synthetic
import multimodal_gar_tpu.data.voxelizer as jax_voxelizer
import multimodal_gar_tpu.eval.ap as jax_ap
import multimodal_gar_tpu.eval.jrdb_eval as jax_jrdb_eval
import multimodal_gar_tpu.native as jax_native
import multimodal_gar_tpu.utils.metrics as jax_metrics
import multimodal_gar_tpu_torch.config as port_config
import multimodal_gar_tpu_torch.data.decode_pool as port_decode_pool
import multimodal_gar_tpu_torch.data.pointcloud as port_pointcloud
import multimodal_gar_tpu_torch.data.rulebook as port_rulebook
import multimodal_gar_tpu_torch.data.synthetic as port_synthetic
import multimodal_gar_tpu_torch.data.voxelizer as port_voxelizer
import multimodal_gar_tpu_torch.eval.ap as port_ap
import multimodal_gar_tpu_torch.eval.jrdb_eval as port_jrdb_eval
import multimodal_gar_tpu_torch.native as port_native
import multimodal_gar_tpu_torch.utils.metrics as port_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIL3 = os.path.join(ROOT, "configs", "mil3.yaml")


def _equal_trees(a, b, what=""):
    """Exact equality of nested dicts / tuples / arrays / scalars."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), what
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _equal_trees(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("overrides", [
    [], ["train.batch_size=2", "model.fusion.sigma=5.0"]],
    ids=["mil3", "mil3+two_overrides"])
def test_config_copy_loads_the_same_tree(overrides):
    ref = jax_config.load_config(MIL3, overrides=overrides)
    got = port_config.load_config(MIL3, overrides=overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert port_config.config_to_dict(got) == jax_config.config_to_dict(ref)
    assert got.data.point_cloud.grid_size == ref.data.point_cloud.grid_size
    if overrides:
        assert got.train.batch_size == 2 and got.model.fusion.sigma == 5.0


def test_config_copy_defaults_and_fields_are_the_originals():
    assert dataclasses.asdict(port_config.Config()) \
        == dataclasses.asdict(jax_config.Config())
    for name in ("Config", "DataConfig", "PointCloudConfig", "ModelConfig",
                 "RGBBackboneConfig", "LiDARBackboneConfig", "FusionConfig",
                 "TrainConfig", "StageConfig", "MeshConfig"):
        ref = [(f.name, f.type) for f in
               dataclasses.fields(getattr(jax_config, name))]
        got = [(f.name, f.type) for f in
               dataclasses.fields(getattr(port_config, name))]
        assert got == ref, name


def _coords(seed, m=300, n_valid=220, shape=(9, 40, 40)):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, s, m) for s in shape],
                      -1).astype(np.int32)
    keys = (coords[:, 0].astype(np.int64) * shape[1] + coords[:, 1]) \
        * shape[2] + coords[:, 2]
    _, first = np.unique(keys, return_index=True)
    coords = coords[np.sort(first)][:n_valid]
    nv = len(coords)
    coords = np.concatenate([coords, np.full((m - nv, 3), -1, np.int32)])
    return coords, nv, shape


@pytest.mark.parametrize("path", ["numpy", "native"])
@pytest.mark.parametrize("x_window", [True, False],
                         ids=["x_window", "nbr_maps_only"])
def test_rulebook_copy_builds_the_same_maps(path, x_window, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(jax_native, "load_native", lambda: None)
        monkeypatch.setattr(port_native, "load_native", lambda: None)
    else:
        assert jax_native.load_native() is not None
        assert port_native.load_native() is not None
    for seed in (0, 1):
        coords, nv, shape = _coords(seed)
        caps = (300, 300, 150, 75)
        ref = jax_rulebook.build_rulebook(coords, nv, shape, caps,
                                          x_window=x_window)
        got = port_rulebook.build_rulebook(coords, nv, shape, caps,
                                           x_window=x_window)
        assert ("win_0" in got) == x_window
        _equal_trees(got, ref, f"rulebook seed {seed}")


def test_native_copy_builds_its_own_library():
    """The port compiles native/*.cpp into its own build directory: the two
    packages share no built file."""
    lib = port_native.load_native()
    assert lib is not None
    build = os.path.join(os.path.dirname(port_native.__file__), os.pardir,
                         "build")
    assert os.path.samefile(os.path.dirname(lib._name), build)
    assert lib._name != jax_native.load_native()._name


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["numpy", "native"])
def test_voxelizer_copy_voxelizes_the_same(use_native):
    rng = np.random.default_rng(2)
    pts = rng.uniform([-6, -6, -2, 0], [6, 6, 3, 1],
                      size=(500, 4)).astype(np.float32)
    kw = dict(voxel_size=(0.5, 0.5, 0.625),
              point_cloud_range=(-6.0, -6.0, -2.0, 6.0, 6.0, 3.0),
              max_points_per_voxel=5, max_voxels=128, use_native=use_native)
    ref = jax_voxelizer.Voxelizer(**kw)(pts)
    got = port_voxelizer.Voxelizer(**kw)(pts)
    _equal_trees(tuple(got), tuple(ref), "voxelizer")
    _equal_trees(tuple(port_voxelizer.pad_voxels(got, 128, 4, 5)),
                 tuple(jax_voxelizer.pad_voxels(ref, 128, 4, 5)),
                 "pad_voxels")


def test_synthetic_and_pointcloud_copies(tmp_path):
    """write_synthetic_jrdb writes the same tree, and load_dual_velodyne
    reads a .pcd of it to the same points."""
    roots = {}
    for name, mod in (("jax", jax_synthetic), ("port", port_synthetic)):
        roots[name] = str(tmp_path / name)
        mod.write_synthetic_jrdb(roots[name], num_seqs=1, frames_per_seq=3,
                                 people_per_frame=4, image_hw=(48, 80))

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(roots["jax"])
    assert names == files(roots["port"]) and len(names) > 6
    for rel in names:
        assert filecmp.cmp(os.path.join(roots["jax"], rel),
                           os.path.join(roots["port"], rel),
                           shallow=False), rel
    pcd = next(n for n in names if n.endswith(".pcd")
               and "lower_velodyne" in n)
    path = os.path.join(roots["port"], pcd)
    for num_points in (None, 96):
        ref = jax_pointcloud.load_dual_velodyne(
            path, num_points=num_points, rng=np.random.default_rng(3))
        got = port_pointcloud.load_dual_velodyne(
            path, num_points=num_points, rng=np.random.default_rng(3))
        _equal_trees(got, ref, "load_dual_velodyne")
    calib = os.path.join(roots["port"], "train_dataset_with_activity",
                         "calibration", "defaults.yaml")
    assert [dataclasses.asdict(c) for c in
            port_pointcloud.load_velodyne_calibs(calib)] \
        == [dataclasses.asdict(c) for c in
            jax_pointcloud.load_velodyne_calibs(calib)]


class _SeededSamples:
    """A dataset whose sample is a function of (epoch, index), as the
    augmenting datasets are; index 5 cannot be decoded."""

    def __init__(self):
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 is broken")
        rng = np.random.default_rng(1000 * self.epoch + i)
        return {"x": rng.normal(size=(3, 4)).astype(np.float32),
                "nested": {"i": np.int32(i), "epoch": np.int32(self.epoch)}}


def test_decode_pool_copy_yields_the_same_stream():
    """Both pools over one dataset: the same samples in the order asked
    for, the epoch forwarded to the workers, a worker's error raised in the
    parent with the same message, and the pool usable afterwards."""
    ds = _SeededSamples()
    order = [3, 0, 7, 1, 1, 6, 2, 4, 0]
    streams = {}
    for name, mod in (("jax", jax_decode_pool), ("port", port_decode_pool)):
        with mod.ProcessDecodePool(ds, num_workers=2) as pool:
            assert pool.max_inflight == 4
            got = [list(pool.imap(order, epoch=e)) for e in (0, 3)]
            with pytest.raises(RuntimeError) as err:
                list(pool.imap([4, 5, 6], epoch=1))
            after = list(pool.imap([2], epoch=1))
            procs = list(pool._procs)
        assert not any(p.is_alive() for p in procs), name
        streams[name] = (got, str(err.value), after)
    _equal_trees(streams["port"][0], streams["jax"][0], "imap")
    assert streams["port"][1] == streams["jax"][1]
    assert "ValueError: sample 5 is broken" in streams["port"][1]
    _equal_trees(streams["port"][2], streams["jax"][2], "after an error")
    want = []
    for e in (0, 3):
        ds.set_epoch(e)
        want.append([ds[i] for i in order])
    _equal_trees(streams["port"][0], want, "against the serial path")
    with pytest.raises(ValueError):
        port_decode_pool.ProcessDecodePool(ds, num_workers=0)


def _fill(acc, seed, frames=4, n=8):
    rng = np.random.default_rng(seed)
    for frame in range(frames):
        xy = rng.uniform(0, 60, size=(n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 20, size=(n, 2))],
                               -1).astype(np.float32)
        valid = np.arange(n) < 6
        acc.add_frame(
            0, frame, boxes, valid,
            (rng.uniform(size=(n, 27)) < 0.2).astype(np.float32),
            (rng.uniform(size=(n, 27)) < 0.2).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32),
            rng.uniform(size=(n, 27)).astype(np.float32),
            rng.uniform(size=(n, 27)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32),
            rng.uniform(size=n).astype(np.float32))


def test_jrdb_eval_and_ap_copies_score_the_same():
    ref_acc, got_acc = (jax_jrdb_eval.ResultAccumulator(),
                        port_jrdb_eval.ResultAccumulator())
    _fill(ref_acc, 4)
    _fill(got_acc, 4)
    ref, got = ref_acc.evaluate_all(), got_acc.evaluate_all()
    assert got == ref and any(v > 0 for v in ref.values())
    for label in list(ref_acc.det_action)[:5]:
        assert port_ap.detection_ap(got_acc.det_action[label],
                                    got_acc.gt_action[label]) \
            == jax_ap.detection_ap(ref_acc.det_action[label],
                                   ref_acc.gt_action[label])
    assert port_ap.set_detection_ap(got_acc.det_groups, got_acc.gt_groups) \
        == jax_ap.set_detection_ap(ref_acc.det_groups, ref_acc.gt_groups)


def test_metrics_copy_writes_the_same_log(tmp_path):
    lines = {}
    for name, mod in (("jax", jax_metrics), ("port", port_metrics)):
        writer = mod.MetricWriter(str(tmp_path / name), echo=False)
        writer.write(3, {"loss": 1.5, "acc": 0.25}, prefix="train/")
        writer.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        for row in rows:
            row.pop("ts")
        lines[name] = rows
        meter = mod.AverageMeter()
        meter.update(2.0, 3)
        meter.update(4.0)
        lines[name].append(meter.avg)
    assert lines["port"] == lines["jax"]
