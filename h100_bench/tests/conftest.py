"""The benchmark's own tests: its files, counts, generators and reference
on the CPU at tiny sizes, and its comparison against planted faults. Run
them from the repository's root:

    python -m pytest h100_bench/tests -q

Tests marked ``cuda`` need a card and skip without one."""
import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _path in (BENCH, ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

# the sizes of the port's tiny test configuration (utils/testing.py:
# tiny_config) over every configuration file's own settings
TINY_OVERRIDES = {
    "data": {"image_size": [48, 64], "num_frames": 3, "num_boxes": 8,
             "point_cloud": {"num_points": 256,
                             "range": [-8.0, -8.0, -2.0, 8.0, 8.0, 3.0],
                             "voxel": {"voxel_size": [0.5, 0.5, 0.625],
                                       "max_voxels_train": 256,
                                       "max_voxels_test": 256}}},
    "model": {"lidar": {"grid_pool_size": 2, "pool_layers": [
        {"source": "x_conv2", "mlps": [8, 8], "query_range": [2, 2, 2],
         "radius": 1.0, "nsample": 4, "pool_method": "max_pool"},
        {"source": "x_conv4", "mlps": [8, 8], "query_range": [2, 2, 2],
         "radius": 4.0, "nsample": 4, "pool_method": "max_pool"}]}}}
TINY_CAPS = [256, 128, 64, 32]
TINY_SCENE = {"actors": [2, 6], "actor_radius_m": [1.0, 6.0], "points": 256,
              "ground_rings": 3, "ring_start_m": 1.5, "ring_step": 1.4,
              "ring_points": 40, "walls": [1, 2], "wall_points": 60,
              "wall_distance_m": [3.0, 7.0], "wall_length_m": [2.0, 5.0],
              "wall_rows": 4, "wall_height_m": 2.0, "min_actor_points": 10,
              "image_block": 8}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) \
            and isinstance(base.get(k), dict) else v
    return out


def tiny_spec(workload: str, seed: int, pool: int = 3) -> dict:
    """The cell's spec at tiny sizes on the CPU."""
    import run
    spec = copy.deepcopy(run.cell_spec(workload, seed, "cpu"))
    cfg = spec["config"]
    cfg["overrides"] = _merge(cfg["overrides"], TINY_OVERRIDES)
    cfg["stage_caps"] = {k: TINY_CAPS for k in cfg["stage_caps"]}
    spec["mix"]["params"].update(TINY_SCENE)
    spec["mix"]["pool"] = pool
    spec["workload"]["warmup_requests"] = 1
    return spec


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")
