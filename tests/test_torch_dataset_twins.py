"""The port's dataset adapters, offline builders and eval suites against the
JAX package's, by running each JAX test of them twice: once as it is, and
once with every name it takes from ``multimodal_gar_tpu`` bound to the
port's module of the same relative path (``multimodal_gar_tpu_torch``).

The twins are the JAX package's tests of the datasets (tests/test_nuscenes.py,
test_waymo_lyft.py, test_once_custom.py, test_pandaset_argo2.py and
test_kitti.py's registry and builders tests), on the fixture trees those
tests write. Each run of a test records every value that the test takes from
the package: the frames, ``det_batch`` DetBatches and ``evaluation`` results
of each dataset it builds, and the result of each function of the package it
calls. So a twin holds the port to the JAX test's own assertions and holds
the two runs' records equal: frames and DetBatches leaf for leaf exactly
(torch tensors against jax arrays), eval results exactly and float64 values
to 1e-12.

One adaptation: the port's ``det_batches`` puts batches on the card by
default, so the port's run passes ``device="cpu"``.
"""
import ast
import dataclasses
import functools
import importlib
import inspect
import pathlib
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

# the JAX tests' fixture trees, for request.getfixturevalue
from tests.test_nuscenes import nusc_root  # noqa: F401
from tests.test_pandaset_argo2 import argo2_root, pandaset_root  # noqa: F401
from tests.test_waymo_lyft import lyft_root, waymo_root  # noqa: F401

JAX_PKG, PORT_PKG = "multimodal_gar_tpu", "multimodal_gar_tpu_torch"
TWINNED = {"tests.test_nuscenes": None, "tests.test_waymo_lyft": None,
           "tests.test_once_custom": None, "tests.test_pandaset_argo2": None,
           "tests.test_kitti": ("test_dataset_registry",
                                "test_offline_builders_roundtrip")}
# the methods of a dataset (a class with ``frame``) whose results a run
# records
RECORDED = ("__len__", "frame", "det_batch", "evaluation")
F64_RTOL = 1e-12


def _cases():
    for modname, names in TWINNED.items():
        mod = importlib.import_module(modname)
        for name, obj in vars(mod).items():
            if name.startswith("test_") and callable(obj) \
                    and (names is None or name in names):
                yield pytest.param(modname, name,
                                   id=f"{modname.split('.')[-1]}::{name}")


def _plain(x):
    """A recorded value as numpy arrays, dicts, lists and scalars: the
    two packages' types (torch tensors, jax arrays, their own dataclasses)
    compare as the same tree."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, (jax.Array, np.ndarray)):
        return np.array(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__type__": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, np.generic)):
        return x
    return f"<{type(x).__name__}>"


def _same(a, b, where: str) -> None:
    """Exact equality of two recorded trees; float64 to F64_RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict), where
        keys = list(a) + [k for k in b if k not in a]
        for k in keys:
            if k not in a or k not in b:       # a field only one side has
                assert a.get(k) is None and b.get(k) is None, f"{where}/{k}"
            else:
                _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == np.float64:
            np.testing.assert_allclose(b, a, rtol=F64_RTOL, atol=0,
                                       equal_nan=True, err_msg=where)
        else:
            np.testing.assert_array_equal(b, a, err_msg=where)
    elif isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), where
        assert (np.isnan(a) and np.isnan(b)) or a == b \
            or abs(a - b) <= F64_RTOL * max(abs(a), abs(b)), (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


class _Run:
    """One run of a JAX test against package ``pkg``: proxies of the
    package's modules whose functions and dataset classes record what they
    return into ``log``."""

    def __init__(self, pkg: str, adapt=None):
        self.pkg, self.log, self.proxies = pkg, [], {}
        self.adapt = adapt or {}

    def module(self, jax_name: str) -> types.ModuleType:
        """The recording proxy of this run's module for a JAX module name."""
        if jax_name not in self.proxies:
            real = importlib.import_module(self.pkg + jax_name[len(JAX_PKG):])
            proxy = types.ModuleType(real.__name__)
            for k, v in vars(real).items():
                proxy.__dict__[k] = self._wrap(v, real.__name__)
            self.proxies[jax_name] = proxy
        return self.proxies[jax_name]

    def _wrap(self, v, modname: str):
        if getattr(v, "__module__", None) != modname:
            return v                          # not defined in this module
        rel = modname[len(self.pkg) + 1:]
        if isinstance(v, types.FunctionType):
            fn = self.adapt.get(f"{rel}.{v.__name__}", lambda f: f)(v)

            @functools.wraps(v)
            def call(*a, **k):
                out = fn(*a, **k)
                self.log.append((f"{rel}.{v.__name__}", _plain(out)))
                return out
            return call
        if isinstance(v, type) and hasattr(v, "frame"):
            log = self.log

            def method(name):
                base = getattr(v, name)

                def call(obj, *a, **k):
                    out = base(obj, *a, **k)
                    log.append((f"{rel}.{v.__name__}.{name}", _plain(out)))
                    return out
                return call
            return type(v.__name__, (v,), {m: method(m) for m in RECORDED
                                           if hasattr(v, m)})
        return v

    def bind(self, fn):
        """``fn`` with its globals' package names bound to this run's
        proxies, and the test module's helpers with it."""
        old = fn.__globals__
        new = dict(old)
        for k, v in old.items():
            if isinstance(v, types.ModuleType) \
                    and v.__name__.startswith(JAX_PKG + "."):
                new[k] = self.module(v.__name__)
            elif (getattr(v, "__module__", None) or "").startswith(
                    JAX_PKG + ".") and hasattr(v, "__name__"):
                new[k] = getattr(self.module(v.__module__), v.__name__)
        for k, v in old.items():
            if isinstance(v, types.FunctionType) and v.__globals__ is old:
                new[k] = types.FunctionType(v.__code__, new, v.__name__,
                                            v.__defaults__, v.__closure__)
        return types.FunctionType(fn.__code__, new, fn.__name__,
                                  fn.__defaults__, fn.__closure__)


def _package_modules(mod) -> set:
    """Every multimodal_gar_tpu module the test module imports, at its top
    or inside a function."""
    tree = ast.parse(inspect.getsource(mod))
    return {node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module
            and node.module.startswith(JAX_PKG + ".")}


def _run(run: _Run, fn, kwargs, modules, monkeypatch):
    with monkeypatch.context() as mp:
        for name in modules:
            proxy = run.module(name)
            mp.setitem(sys.modules, name, proxy)
            mp.setitem(sys.modules, PORT_PKG + name[len(JAX_PKG):], proxy)
        run.bind(fn)(**kwargs)
    return run.log


def _clear(path: pathlib.Path) -> None:
    for p in path.iterdir():
        shutil.rmtree(p) if p.is_dir() else p.unlink()


@pytest.mark.parametrize("modname,name", list(_cases()))
def test_port_twin(modname, name, request, monkeypatch):
    mod = importlib.import_module(modname)
    fn = getattr(mod, name)
    args = list(inspect.signature(fn).parameters)
    kwargs = {a: request.getfixturevalue(a) for a in args}
    modules = _package_modules(mod)
    ref = _run(_Run(JAX_PKG), fn, kwargs, modules, monkeypatch)
    if "tmp_path" in kwargs:                 # the test writes its own tree
        _clear(kwargs["tmp_path"])
    port = _Run(PORT_PKG, adapt={"data.registry.det_batches": lambda f:
                                 functools.partial(f, device="cpu")})
    got = _run(port, fn, kwargs, modules, monkeypatch)
    assert ref, "the JAX run recorded nothing"
    assert [k for k, _ in got] == [k for k, _ in ref]
    for i, ((what, r), (_, g)) in enumerate(zip(ref, got)):
        _same(r, g, f"record {i} {what}")
