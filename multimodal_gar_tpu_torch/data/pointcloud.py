"""Point-cloud IO + JRDB sensor-frame transforms.

Re-provides the reference's *missing* ``data`` package (imported at
dataloader.py:8-9 but absent from the repo): ``load_pointcloud``,
``get_lidar_with_sweeps`` and the jrdb_transforms
``transform_pts_{upper,lower}_velodyne_to_base`` functions, re-implemented
from the documented JRDB sensor layout.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# PCD parsing (ASCII + binary), numpy
# ---------------------------------------------------------------------------

_PCD_DTYPES = {("F", 4): np.float32, ("F", 8): np.float64,
               ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
               ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def load_pcd(path: str, num_features: int = 4) -> np.ndarray:
    """Parse a .pcd file -> (N, num_features) float32 (x, y, z, intensity...).

    Supports ASCII and binary encodings (the JRDB release ships binary PCDs).
    Missing fields (e.g. no intensity) are zero-filled.
    """
    with open(path, "rb") as f:
        header = {}
        while True:
            raw = f.readline()
            if not raw:                  # EOF before DATA: corrupt header
                raise ValueError(f"truncated PCD header in {path!r}")
            line = raw.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        data_mode = header["DATA"][0].lower()

        np_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            dt = _PCD_DTYPES[(typ, size)]
            if cnt == 1:
                np_fields.append((name, dt))
            else:
                np_fields.append((name, dt, (cnt,)))
        dtype = np.dtype(np_fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = raw.reshape(n, -1)
            rec = np.zeros(n, dtype)
            col = 0
            for name, cnt in zip(fields, counts):
                if cnt == 1:
                    rec[name] = raw[:, col]
                else:
                    rec[name] = raw[:, col:col + cnt]
                col += cnt
        elif data_mode == "binary":
            rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        else:
            raise ValueError(f"unsupported PCD DATA mode {data_mode!r}")

    out = np.zeros((n, num_features), np.float32)
    wanted = ["x", "y", "z", "intensity"][:num_features]
    for i, name in enumerate(wanted):
        if name in fields:
            out[:, i] = rec[name].astype(np.float32)
    # drop non-finite points (JRDB PCDs contain NaN returns)
    return out[np.isfinite(out[:, :3]).all(axis=1)]


# ---------------------------------------------------------------------------
# JRDB velodyne -> robot-base frame
# ---------------------------------------------------------------------------

@dataclass
class VelodyneCalib:
    """Rigid transform of one velodyne into the robot base frame.

    Defaults follow the public JRDB calibration (jrdb_toolkit
    ``jrdb_transforms``): each lidar is yaw-rotated ~0.085 rad and offset in z;
    override per-deployment via the dataset config if needed.
    """
    yaw: float = 0.0
    translation: tuple = (0.0, 0.0, 0.0)

    def apply(self, xyz: np.ndarray) -> np.ndarray:
        """xyz: (N, 3) sensor-frame points -> base-frame points."""
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)
        return (xyz @ rot.T + np.asarray(self.translation)).astype(xyz.dtype)


UPPER_VELODYNE_CALIB = VelodyneCalib(yaw=0.085, translation=(0.0, 0.0, 0.33529))
LOWER_VELODYNE_CALIB = VelodyneCalib(yaw=0.0, translation=(0.0, 0.0, -0.13511))


def load_velodyne_calibs(calib_path: str
                         ) -> tuple["VelodyneCalib", "VelodyneCalib"]:
    """Parse a JRDB calibration YAML -> (upper, lower) VelodyneCalib.

    JRDB ships ``calibration/defaults.yaml`` with per-sensor rigid transforms
    under keys containing ``lidar_upper``/``lidar_lower`` (each carrying a
    3-vector ``translation`` and an ``rpy``/``rotation`` 3-vector whose last
    component is the yaw). Key layout varies across releases, so the lookup
    is tolerant: any mapping whose key names the sensor is accepted.
    Falls back to the documented constants when the file is missing or no
    matching entry is found.
    """
    import yaml

    try:
        with open(calib_path) as f:
            doc = yaml.safe_load(f)
    except (FileNotFoundError, OSError):
        return UPPER_VELODYNE_CALIB, LOWER_VELODYNE_CALIB

    found = {}

    def visit(node, name=""):
        if not isinstance(node, dict):
            return
        trans = node.get("translation")
        rot = node.get("rpy", node.get("rotation"))
        if trans is not None and hasattr(trans, "__len__") and len(trans) == 3:
            lname = name.lower()
            for sensor in ("upper", "lower"):
                if sensor in lname and ("lidar" in lname
                                        or "velodyne" in lname):
                    yaw = float(rot[2]) if (rot is not None
                                            and hasattr(rot, "__len__")
                                            and len(rot) == 3) else 0.0
                    found.setdefault(
                        sensor,
                        VelodyneCalib(yaw=yaw,
                                      translation=tuple(float(t)
                                                        for t in trans)))
        for k, v in node.items():
            visit(v, str(k))

    visit(doc if isinstance(doc, dict) else {})
    return (found.get("upper", UPPER_VELODYNE_CALIB),
            found.get("lower", LOWER_VELODYNE_CALIB))


def transform_pts_upper_velodyne_to_base(xyz: np.ndarray) -> np.ndarray:
    return UPPER_VELODYNE_CALIB.apply(xyz)


def transform_pts_lower_velodyne_to_base(xyz: np.ndarray) -> np.ndarray:
    return LOWER_VELODYNE_CALIB.apply(xyz)


def sample_points(points: np.ndarray, num_points: int,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Fix the point count (reference ``get_lidar_with_sweeps`` semantics,
    dataloader.py:129): subsample without replacement when too many, pad by
    resampling when too few."""
    rng = rng or np.random.default_rng(0)
    n = len(points)
    if n == 0:
        return np.zeros((num_points, points.shape[1]), points.dtype)
    if n >= num_points:
        idx = rng.choice(n, num_points, replace=False)
    else:
        idx = np.concatenate([np.arange(n),
                              rng.choice(n, num_points - n, replace=True)])
    return points[idx]


def load_dual_velodyne(lower_path: str, num_features: int = 4,
                       num_points: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None,
                       calibs: Optional[tuple] = None) -> np.ndarray:
    """Load lower+upper velodyne PCDs, transform both to base, concat, sample.

    Mirrors reference JRDB_act.load_pc (dataloader.py:119-131); the upper
    scan's path is derived by the lower->upper directory substitution.
    ``calibs``: optional (upper, lower) VelodyneCalib pair (e.g. from
    load_velodyne_calibs); defaults to the documented constants.
    """
    upper_calib, lower_calib = calibs or (UPPER_VELODYNE_CALIB,
                                          LOWER_VELODYNE_CALIB)
    lower = load_pcd(lower_path, num_features)
    upper_path = lower_path.replace("lower_velodyne", "upper_velodyne")
    try:
        upper = load_pcd(upper_path, num_features)
    except FileNotFoundError:
        upper = np.zeros((0, num_features), np.float32)
    lower[:, :3] = lower_calib.apply(lower[:, :3])
    if len(upper):
        upper[:, :3] = upper_calib.apply(upper[:, :3])
    pc = np.concatenate([upper, lower], axis=0)
    if num_points is not None:
        pc = sample_points(pc, num_points, rng)
    return pc
