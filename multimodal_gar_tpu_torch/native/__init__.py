"""ctypes bindings to the native host components (native/voxelizer.cpp,
native/rulebook.cpp at the repository root).

The port's own copy of multimodal_gar_tpu/native/__init__.py: the bindings
are the same, the library is not shared. The two sources are compiled with
the flags of native/Makefile straight into
``multimodal_gar_tpu_torch/build/libmgar_native-<source hash>.so`` at first
use. The library is optional: without a C++ compiler or the sources,
callers (data/voxelizer.py, data/rulebook.py) fall back to the pure-numpy
implementations.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SOURCES = ("voxelizer.cpp", "rulebook.cpp")
# native/Makefile's CXXFLAGS
_CXXFLAGS = "-O3 -march=native -std=c++17 -shared -fPIC -Wall"

_lib: Optional[ctypes.CDLL] = None


def _build() -> Optional[str]:
    """Path of the built library (compiling it if this source state has no
    build yet); None without the sources or a compiler, or on a failed
    build."""
    sources = [os.path.join(_SRC_DIR, f) for f in _SOURCES]
    if not all(os.path.exists(p) for p in sources):
        return None
    h = hashlib.sha256(_CXXFLAGS.encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    target = os.path.join(_BUILD_DIR,
                          f"libmgar_native-{h.hexdigest()[:16]}.so")
    if os.path.exists(target):
        return target
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *shlex.split(_CXXFLAGS), *sources, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, target)
    return target


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.mgar_voxelize.restype = ctypes.c_int
    lib.mgar_voxelize.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,          # points, n, c
        f32p, f32p, f32p,                          # voxel_size, rmin, rmax
        ctypes.c_int, ctypes.c_int,                # max_points, max_voxels
        f32p, i32p, i32p]                          # out voxels/coords/nump
    lib.mgar_transform_points.restype = None
    lib.mgar_transform_points.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, f32p]
    _lib = lib
    return lib


def native_voxelize(points: np.ndarray, voxel_size, point_cloud_range,
                    max_points_per_voxel: int, max_voxels: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """C++ voxelization; returns (voxels, coords_zyx, num_points) or None."""
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    n, c = pts.shape
    voxels = np.zeros((max_voxels, max_points_per_voxel, c), np.float32)
    coords = np.zeros((max_voxels, 3), np.int32)
    nump = np.zeros((max_voxels,), np.int32)
    vs = np.ascontiguousarray(voxel_size, np.float32)
    rmin = np.ascontiguousarray(point_cloud_range[:3], np.float32)
    rmax = np.ascontiguousarray(point_cloud_range[3:6], np.float32)
    m = lib.mgar_voxelize(pts, n, c, vs, rmin, rmax,
                          max_points_per_voxel, max_voxels,
                          voxels, coords, nump)
    return voxels[:m], coords[:m], nump[:m]


def native_rulebook(coords: np.ndarray, n_valid: int, spatial_shape,
                    caps) -> Optional[dict]:
    """C++ 4-stage rulebook construction; returns the same dict layout as
    data/rulebook.build_rulebook, or None if the library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    if not hasattr(lib, "_rulebook_bound"):
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.mgar_build_rulebook.restype = None
        lib.mgar_build_rulebook.argtypes = [
            i32p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p] + [i32p] * 10 + [i32p]
        lib._rulebook_bound = True
    caps = np.ascontiguousarray(caps, np.int32)
    c0 = np.ascontiguousarray(coords[:int(caps[0])], np.int32)
    nbr = [np.empty((int(caps[k]), 27), np.int32) for k in range(4)]
    out_coords = [None] + [np.empty((int(caps[k]), 3), np.int32)
                           for k in range(1, 4)]
    down = [None] + [np.empty((int(caps[k]), 27), np.int32)
                     for k in range(1, 4)]
    counts = np.zeros(4, np.int32)
    z, y, x = spatial_shape
    lib.mgar_build_rulebook(
        c0, int(min(n_valid, caps[0])), z, y, x, caps,
        nbr[0], out_coords[1], down[1], nbr[1],
        out_coords[2], down[2], nbr[2],
        out_coords[3], down[3], nbr[3], counts)
    out = {"nbr_0": nbr[0]}
    for k in range(1, 4):
        out[f"coords_{k}"] = out_coords[k]
        out[f"count_{k}"] = np.int32(counts[k])
        out[f"down_{k}"] = down[k]
        out[f"nbr_{k}"] = nbr[k]
    return out


def native_xwindow(rb: dict, coords0: np.ndarray, n_valid0: int,
                   spatial_shape, caps) -> bool:
    """C++ x-window maps (order_0/win_k/dwin_k) appended into ``rb``.

    Requires the stage active sets already present in ``rb`` (coords_k /
    count_k from either rulebook version). Returns False when the native
    library is unavailable (callers fall back to numpy).
    """
    lib = load_native()
    if lib is None:
        return False
    if not hasattr(lib, "_xwindow_bound"):
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.mgar_build_xwindow.restype = None
        lib.mgar_build_xwindow.argtypes = (
            [i32p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p]
            + [i32p, ctypes.c_int] * 3 + [i32p] * 8)
        lib._xwindow_bound = True
    caps = np.ascontiguousarray(caps, np.int32)
    cap0 = int(caps[0])
    c0 = np.full((cap0, 3), -1, np.int32)
    n0 = int(min(n_valid0, cap0, len(coords0)))
    c0[:n0] = coords0[:n0]
    order0 = np.empty((cap0,), np.int32)
    wins = [np.empty((int(caps[k]), 9), np.int32) for k in range(4)]
    dwins = [None] + [np.empty((int(caps[k]), 9), np.int32)
                      for k in range(1, 4)]
    cks = [np.ascontiguousarray(rb[f"coords_{k}"], np.int32)
           for k in range(1, 4)]
    z, y, x = spatial_shape
    lib.mgar_build_xwindow(
        c0, n0, z, y, x, caps,
        cks[0], int(rb["count_1"]), cks[1], int(rb["count_2"]),
        cks[2], int(rb["count_3"]),
        order0, wins[0], wins[1], wins[2], wins[3],
        dwins[1], dwins[2], dwins[3])
    rb["order_0"] = order0
    for k in range(4):
        rb[f"win_{k}"] = wins[k]
        if k > 0:
            rb[f"dwin_{k}"] = dwins[k]
    return True
