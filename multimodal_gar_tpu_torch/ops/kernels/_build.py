"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>-<source hash>.so`` at first use, and
loaded with ctypes; pointers and the stream are passed as Python ints. The
hash covers the source and the shared headers (``csrc/*.cuh``), so a
changed source or header gets a fresh build. ``load_all`` builds several
libraries at once, one nvcc each. Nothing here falls back: a missing
``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


class KernelLibrary:
    """One ``csrc/<name>.cu`` compiled into a ctypes library on first use.

    ``build_seconds`` is the nvcc time of this process's build (0.0 when an
    existing build was loaded); ``ptxas_log`` holds what ``-Xptxas -v``
    printed (registers, shared memory and spills per kernel). ``csrc_dir``
    names another directory of sources than the package's own: another
    version of the same kernels, built beside them for a comparison
    (tools/compare_csrc.py).
    """

    def __init__(self, name: str, bind, csrc_dir: str = CSRC_DIR):
        self.name = name
        self._bind = bind            # sets argtypes/restype on the CDLL
        self.csrc_dir = csrc_dir
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.ptxas_log = ""

    @property
    def source(self) -> str:
        return os.path.join(self.csrc_dir, f"{self.name}.cu")

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(self._build())
            self._bind(lib)
            self._lib = lib
        return self._lib

    def _build(self) -> str:
        h = hashlib.sha256()
        headers = sorted(p for p in os.listdir(self.csrc_dir)
                         if p.endswith(".cuh"))
        for path in [self.source] + [os.path.join(self.csrc_dir, p)
                                     for p in headers]:
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        target = os.path.join(BUILD_DIR, f"lib{self.name}-{digest}.so")
        if os.path.exists(target):
            self.build_seconds = 0.0
            return target
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                              capture_output=True, text=True, check=False)
        self.build_seconds = time.perf_counter() - t0
        self.ptxas_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n"
                               f"{self.ptxas_log}")
        os.replace(tmp, target)
        return target


def load_all(libraries: Sequence[KernelLibrary]) -> None:
    """Build and load ``libraries`` concurrently (nvcc runs outside the
    GIL), raising the first build failure."""
    with ThreadPoolExecutor(max(len(libraries), 1)) as pool:
        for future in [pool.submit(lib.load) for lib in libraries]:
            future.result()


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` (a tensor's: it has an index)
    as a Python int for ctypes. Read straight from the binding: building a
    ``torch.cuda.Stream`` object per launch costs several times as much."""
    return torch._C._cuda_getCurrentRawStream(device.index)
