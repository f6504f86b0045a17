"""The traffic generators: the same seed gives the same inputs, another
seed others, and the scenes have the shape the mixes ask for."""
import numpy as np
import torch

import harness
from conftest import TINY_SCENE

jrdb = harness.load_module("traffic", "jrdb_clips.py")
vox = harness.load_module("traffic", "voxelize.py")

SIZES = {"num_boxes": 100, "image_size": (720, 1280), "num_actions": 27,
         "num_frames": 15}
BIG = 2 ** 31 + 977          # a seed past 32 signed bits


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_jrdb_clips_repeat_by_seed():
    p = harness.load_json("traffic", "mixes", "jrdb-sensor-rate.json")[
        "params"]
    a, b = jrdb.clip(p, BIG, 3, SIZES, 16), jrdb.clip(p, BIG, 3, SIZES, 16)
    assert _same(a, b)
    assert not np.array_equal(a["points"], jrdb.clip(p, BIG + 1, 3,
                                                     SIZES, 16)["points"])
    assert not np.array_equal(a["points"], jrdb.clip(p, BIG, 4,
                                                     SIZES, 16)["points"])


def test_jrdb_clip_shape():
    p = harness.load_json("traffic", "mixes", "jrdb-train.json")["params"]
    c = jrdb.clip(p, 5, 0, SIZES, 16)
    n = int(c["person_valid"].sum())
    assert p["actors"][0] <= n <= p["actors"][1]
    assert c["points"].shape == (p["points"], 4)
    assert (c["social_group_id"][~c["person_valid"]] == -1).all()
    assert (c["boxes2d"][c["person_valid"]][:, 2:] >
            c["boxes2d"][c["person_valid"]][:, :2]).all()
    # the scene's voxels are clustered: most have a neighbour in the plane
    pc_range = (-100.0, -100.0, -25.0, 100.0, 100.0, 25.0)
    out = vox.Voxelizer((0.1, 0.1, 1.25), pc_range, 5, 40000)(c["points"])
    cells = {tuple(v) for v in out.coords.tolist()}
    near = sum(any((z, y + dy, x + dx) in cells
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                   if dy or dx) for z, y, x in cells)
    assert near > 0.5 * len(cells)


def test_jrdb_frames_repeat_by_seed():
    p = dict(TINY_SCENE)
    sizes = dict(SIZES, image_size=(48, 64), num_frames=3)
    a = jrdb.frames(p, BIG, 2, sizes, "cpu")
    assert a.shape == (3, 48, 64, 3)
    assert torch.equal(a, jrdb.frames(p, BIG, 2, sizes, "cpu"))
    assert not torch.equal(a, jrdb.frames(p, BIG, 3, sizes, "cpu"))


def test_voxelizer_copy_matches_the_port():
    from multimodal_gar_tpu_torch.data.voxelizer import Voxelizer
    p = harness.load_json("traffic", "mixes", "jrdb-train.json")["params"]
    pts = jrdb.clip(p, 7, 0, SIZES, 16)["points"]
    args = ((0.1, 0.1, 1.25), (-100.0, -100.0, -25.0, 100.0, 100.0, 25.0),
            5, 16000)
    mine = vox.Voxelizer(*args)(pts)
    port = Voxelizer(*args, use_native=False)(pts)
    for a, b in zip(mine, port):
        assert np.array_equal(a, b)


def test_every_seed_holds_the_same_work():
    """The actor counts of a pool are one ladder in another order: the
    seed changes the order of the work and not its amount."""
    p = harness.load_json("traffic", "mixes", "jrdb-train.json")["params"]
    counts = [sorted(int(jrdb.clip(p, s, i, SIZES, 16)["person_valid"].sum())
                     for i in range(16)) for s in (1, BIG)]
    assert counts[0] == counts[1]
    assert counts[0][0] == p["actors"][0] and counts[0][-1] == p["actors"][1]
    order = [[int(jrdb.clip(p, s, i, SIZES, 16)["person_valid"].sum())
              for i in range(4)] for s in (1, BIG)]
    assert order[0] != order[1]
