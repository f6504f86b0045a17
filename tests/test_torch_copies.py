"""The port's own copies of the JAX package's framework-neutral modules
(config, data/rulebook + native, data/voxelizer, data/pointcloud,
data/synthetic, data/decode_pool, eval/jrdb_eval, eval/ap, utils/metrics,
and for the detectors detection/anchors, data/processor, data/kitti,
data/augmentor, eval/kitti_eval and detection/convert's numpy part, and the
dataset adapters, builders and eval suites) against the
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


# ---------------------------------------------------------------------------
# the detector zoo's neutral modules
# ---------------------------------------------------------------------------

def test_anchors_copy():
    import multimodal_gar_tpu.detection.anchors as ja
    import multimodal_gar_tpu_torch.detection.anchors as pa
    assert filecmp.cmp(ja.__file__, pa.__file__, shallow=False)
    for name in ("KITTI_CLASS_NAMES", "KITTI_POINT_CLOUD_RANGE",
                 "KITTI_VOXEL_SIZE", "KITTI_PILLAR_RANGE",
                 "KITTI_PILLAR_SIZE"):
        assert getattr(pa, name) == getattr(ja, name)
    cfgs = [pa.AnchorClassConfig(**dataclasses.asdict(c))
            for c in ja.KITTI_ANCHORS]
    ref = ja.generate_anchors(ja.KITTI_ANCHORS, (176, 200),
                              ja.KITTI_POINT_CLOUD_RANGE)
    got = pa.generate_anchors(cfgs, (176, 200), pa.KITTI_POINT_CLOUD_RANGE)
    _equal_trees(tuple(got[0]), tuple(ref[0]), "anchors")
    assert got[1] == ref[1]


def test_processor_copy():
    """Byte for byte but mask_boxes_outside_range's corners, which come
    from the port's ops/boxes3d.py on a CPU tensor: equal masks."""
    import multimodal_gar_tpu.data.processor as jp
    import multimodal_gar_tpu_torch.data.processor as pp
    with open(jp.__file__) as f, open(pp.__file__) as g:
        diff = [(a, b) for a, b in zip(f, g) if a != b]
    assert len(diff) == 2 and "jnp" in diff[1][0] and "torch" in diff[1][1]
    rng = np.random.default_rng(3)
    pts = rng.uniform([-10, -50, -4, 0], [80, 50, 2, 1],
                      (2000, 4)).astype(np.float32)
    rng_ = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    _equal_trees(pp.mask_points_outside_range(pts, rng_),
                 jp.mask_points_outside_range(pts, rng_), "points")
    boxes = np.concatenate([rng.uniform([-5, -45, -1], [75, 45, 0], (60, 3)),
                            rng.uniform(0.5, 5, (60, 3)),
                            rng.uniform(-3, 3, (60, 1))], 1).astype(
        np.float32)
    for k in (1, 4):
        _equal_trees(pp.mask_boxes_outside_range(boxes, rng_, k),
                     jp.mask_boxes_outside_range(boxes, rng_, k), "boxes")
    _equal_trees(pp.shuffle_points(pts, np.random.default_rng(1)),
                 jp.shuffle_points(pts, np.random.default_rng(1)), "shuffle")
    _equal_trees(pp.double_flip(pts), jp.double_flip(pts), "double flip")


def test_kitti_copy_frames_and_batches(tmp_path):
    """The same fabricated KITTI tree (tests/test_kitti.py) parses to the
    same frames, and the port's assemble_det_batch pads and rulebooks them
    as the JAX package's does."""
    import multimodal_gar_tpu.data.detbatch as jdb
    import multimodal_gar_tpu.data.kitti as jk
    import multimodal_gar_tpu_torch.data.detbatch as pdb
    import multimodal_gar_tpu_torch.data.kitti as pk
    from tests.test_kitti import _make_kitti_tree
    assert filecmp.cmp(jk.__file__, pk.__file__, shallow=False)
    _make_kitti_tree(str(tmp_path))
    ref = jk.KittiDataset(str(tmp_path)).frame(0)
    got = pk.KittiDataset(str(tmp_path)).frame(0)
    assert set(got) == set(ref)
    for k in ref:
        if k == "calib":
            for f in dataclasses.fields(ref[k]):
                _equal_trees(getattr(got[k], f.name),
                             getattr(ref[k], f.name), f"calib {f.name}")
        else:
            _equal_trees(got[k], ref[k], k)
    args = ([0, 0], (0.4, 0.4, 0.5), 256)
    jb = jdb.assemble_det_batch(jk.KittiDataset(str(tmp_path)), *args)
    pb = pdb.assemble_det_batch(pk.KittiDataset(str(tmp_path)), *args)
    # the port's DetBatch leaves out the camera detectors' fields
    for f in dataclasses.fields(pb):
        r, g = getattr(jb, f.name), getattr(pb, f.name)
        if r is None:
            assert g is None, f.name
        elif isinstance(r, dict):
            assert set(r) == set(g)
            for k in r:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), f.name)


def test_augmentor_copy():
    import multimodal_gar_tpu.data.augmentor as ja
    import multimodal_gar_tpu_torch.data.augmentor as pa
    from tests.test_gt_sampler import _scene_with_objects
    assert filecmp.cmp(ja.__file__, pa.__file__, shallow=False)
    pts, boxes, names = _scene_with_objects([[0, 0, 0], [5, 5, 0]])
    steps = [{"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
             {"NAME": "random_world_rotation",
              "WORLD_ROT_ANGLE": [-0.78, 0.78]},
             {"NAME": "random_world_scaling",
              "WORLD_SCALE_RANGE": [0.95, 1.05]}]
    _equal_trees(tuple(pa.WorldAugmentor(steps, seed=4)(pts, boxes)),
                 tuple(ja.WorldAugmentor(steps, seed=4)(pts, boxes)),
                 "world augmentor")
    scene = [{"points": pts, "gt_boxes": boxes, "gt_names": names}]
    db_ref = ja.build_gt_database(scene, ["pedestrian"])
    db_got = pa.build_gt_database(scene, ["pedestrian"])
    _equal_trees(db_got, db_ref, "gt database")
    tgt = _scene_with_objects([[0, 0, 0]], n_bg=30, seed=2)
    _equal_trees(tuple(pa.GTDatabaseSampler(db_got, {"pedestrian": 2},
                                            seed=1)(*tgt)),
                 tuple(ja.GTDatabaseSampler(db_ref, {"pedestrian": 2},
                                            seed=1)(*tgt)), "gt sampler")


def test_kitti_eval_copy():
    import multimodal_gar_tpu.eval.kitti_eval as je
    import multimodal_gar_tpu_torch.eval.kitti_eval as pe
    assert filecmp.cmp(je.__file__, pe.__file__, shallow=False)
    rng = np.random.default_rng(6)

    def frames(mod):
        out = []
        for i in range(12):
            g = rng_boxes(i, 4)
            d = g[:3] + rng_noise(i, 3)
            out.append(mod.FrameAnnotations(
                gt_boxes=g, gt_names=["Car", "Pedestrian", "Car", "Cyclist"],
                gt_difficulty=np.array([0, 1, 2, 0], np.int32),
                det_boxes=d, det_names=["Car", "Pedestrian", "Car"],
                det_scores=np.array([0.9, 0.6, 0.3], np.float32)))
        return out

    def rng_boxes(i, n):
        r = np.random.default_rng(100 + i)
        return np.concatenate([r.uniform([0, -20, -1], [50, 20, 0], (n, 3)),
                               r.uniform(1, 4, (n, 3)),
                               r.uniform(-3, 3, (n, 1))], 1).astype(
            np.float32)

    def rng_noise(i, n):
        return np.random.default_rng(200 + i).normal(0, 0.2, (n, 7)).astype(
            np.float32)
    del rng
    ref = je.evaluate(frames(je))
    got = pe.evaluate(frames(pe))
    assert got == ref and any(v > 0 for v in ref.values())


def test_detection_convert_copy():
    """detection/convert.py's numpy functions and name maps, and the whole
    pcdet -> flax-layout overlay on a numpy tree."""
    import multimodal_gar_tpu.detection.convert as jc
    import multimodal_gar_tpu_torch.detection.convert as pc
    rng = np.random.default_rng(8)
    for shape, cin, cout in (((3, 3, 3, 8, 4), 4, 8), ((3, 3, 3, 4, 8), 4, 8),
                             ((8, 3, 1, 1, 4), 4, 8)):
        val = rng.normal(size=shape).astype(np.float32)
        _equal_trees(pc.normalize_spconv_kernel(val, cin, cout),
                     jc.normalize_spconv_kernel(val, cin, cout), str(shape))
    w = rng.normal(size=(6, 5, 3, 3)).astype(np.float32)
    _equal_trees(pc.torch_conv2d_to_nhwc(w), jc.torch_conv2d_to_nhwc(w),
                 "conv2d")
    _equal_trees(pc.bev_input_channel_perm(2, 5),
                 jc.bev_input_channel_perm(2, 5), "perm")
    assert pc.SECOND_NAME_MAP == jc.SECOND_NAME_MAP
    assert pc._bev_block_map((5, 5)) == jc._bev_block_map((5, 5))
    assert pc.IGNORED_LEAVES == jc.IGNORED_LEAVES
    sd = {"backbone_3d.conv_input.0.weight": rng.normal(
        size=(3, 3, 3, 16, 4)).astype(np.float32),
        "backbone_3d.conv_input.1.running_mean": rng.normal(
            size=16).astype(np.float32),
        "unknown.weight": np.zeros(2)}
    tree = {"params": {"trunk": {"backbone_3d": {"conv_input": {
        "conv": {"kernel": np.zeros((27, 4, 16), np.float32)},
        "bn": {"scale": np.ones(16, np.float32),
               "bias": np.zeros(16, np.float32)}}}}},
        "batch_stats": {"trunk": {"backbone_3d": {"conv_input": {"bn": {
            "mean": np.zeros(16, np.float32),
            "var": np.ones(16, np.float32)}}}}}}
    got = pc.convert_pcdet_second(sd, tree, strict=False)
    ref = jc.convert_pcdet_second(sd, tree, strict=False)
    assert got[1] == ref[1] == 2
    _equal_trees(jax_tree_to_numpy(got[0]), jax_tree_to_numpy(ref[0]),
                 "converted")
    sd["global_step"] = np.asarray(3)
    assert pc.unconsumed_pcdet_keys(sd) == jc.unconsumed_pcdet_keys(sd)


def jax_tree_to_numpy(tree):
    """Nested dict -> the same with numpy leaves and keys in sorted order
    (jax.tree_util sorts them)."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(tree[k]) for k in sorted(tree)}
    return np.asarray(tree)


DATASET_COPIES = ["data/builders.py", "data/nuscenes.py", "data/waymo.py",
                  "data/lyft.py", "data/once.py", "data/pandaset.py",
                  "data/argo2.py", "data/custom.py", "eval/nuscenes_eval.py",
                  "eval/waymo_eval.py", "eval/lyft_eval.py",
                  "eval/once_eval.py", "eval/argo2_eval.py"]


@pytest.mark.parametrize("rel", DATASET_COPIES)
def test_dataset_and_eval_copies(rel):
    """The dataset adapters, builders and eval suites are byte-for-byte
    copies; their relative imports resolve inside the port, so every
    function and class a copy takes from another module of a package is
    the port's (tests/test_torch_dataset_twins.py runs the JAX package's
    tests of them on both)."""
    import importlib
    name = rel[:-3].replace("/", ".")
    jax_mod = importlib.import_module(f"multimodal_gar_tpu.{name}")
    port_mod = importlib.import_module(f"multimodal_gar_tpu_torch.{name}")
    assert filecmp.cmp(jax_mod.__file__, port_mod.__file__, shallow=False)
    borrowed = {k: v for k, v in vars(port_mod).items()
                if (getattr(v, "__module__", None) or "").startswith(
                    "multimodal_gar_tpu")
                and v.__module__ != port_mod.__name__}
    assert all(v.__module__.startswith("multimodal_gar_tpu_torch.")
               for v in borrowed.values()), borrowed
    assert set(borrowed) == {k for k, v in vars(jax_mod).items()
                             if (getattr(v, "__module__", None) or ""
                                 ).startswith("multimodal_gar_tpu.")
                             and v.__module__ != jax_mod.__name__}
