"""What every cell of the benchmark shares: finding a cell's files by name,
the weights drawn from the seed on the device, set-up timing, CUDA-event
spans at module boundaries, the profiler's device trace and its reduction,
the per-layer metric readers, and the result line.

Nothing here imports the program: the drivers (drivers/<family>.py) do.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded where the result is printed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "multimodal_gar_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(*parts: str):
    """A module of the benchmark by its file path (names may hold '-' and
    '.'), registered under a private name."""
    path = os.path.join(BENCH_DIR, *parts)
    name = "h100_bench_file_" + "_".join(parts).replace(".", "_").replace(
        "-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def _tupled(value):
    """JSON lists as tuples, all the way down (config dataclasses hold
    tuples, and frozen ones are hashed)."""
    if isinstance(value, list):
        return tuple(_tupled(v) for v in value)
    return value


def apply_overrides(obj, over: dict):
    """``obj`` (a config dataclass) with the fields of ``over`` replaced;
    a dict goes into a dataclass field, a list of dicts becomes a tuple of
    the field's element class, other lists become tuples."""
    changes = {}
    for key, value in over.items():
        cur = getattr(obj, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(cur):
            changes[key] = apply_overrides(cur, value)
        elif isinstance(value, list) and value and isinstance(value[0], dict):
            cls = type(cur[0])
            changes[key] = tuple(cls(**{k: _tupled(v) for k, v in d.items()})
                                 for d in value)
        else:
            changes[key] = _tupled(value)
    return dataclasses.replace(obj, **changes)


def make_config(config_cls, cfgj: dict, loop: str):
    """The program's (or the reference's) Config for ``loop``: the
    configuration file's overrides on the defaults, and the loop's stage
    caps."""
    cfg = apply_overrides(config_cls(), cfgj["overrides"])
    caps = cfgj["stage_caps"][loop]
    return apply_overrides(cfg, {"model": {"lidar": {
        "max_voxels_per_stage": caps}}})


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _fan_in(leaf: str, shape) -> int:
    if leaf[:2] in ("WQ", "WK", "WV"):              # raw (in, out), x @ W
        return shape[0]
    if len(shape) == 3 and shape[0] == 27:          # sparse (27, Cin, Cout)
        return shape[0] * shape[1]
    n = 1
    for s in shape[1:]:
        n *= s
    return n                                        # Linear / conv (out, ...)


def seeded_weights(state: Dict[str, torch.Tensor], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """Every floating tensor of ``state`` (a state_dict's shapes) drawn anew
    from ``seed`` on ``device``, in three large draws: weights N(0,
    1/fan_in); norm scales and running variances U[0.5, 1.5); biases and
    running means N(0, 0.1). The same seed gives the same tensors."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    kinds = {"scale": [], "shift": [], "weight": []}
    for name, t in state.items():
        if not t.is_floating_point():
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var" or (t.ndim == 1 and leaf == "weight"):
            kinds["scale"].append(name)
        elif t.ndim <= 1:
            kinds["shift"].append(name)
        else:
            kinds["weight"].append(name)
    out: Dict[str, torch.Tensor] = {}
    for kind, names in kinds.items():
        total = sum(state[n].numel() for n in names)
        if kind == "scale":
            flat = 0.5 + torch.rand(total, generator=gen, device=device)
        else:
            flat = torch.randn(total, generator=gen, device=device)
        at = 0
        for n in names:
            t = state[n]
            v = flat[at:at + t.numel()].view(t.shape)
            at += t.numel()
            if kind == "shift":
                v = v * 0.1
            elif kind == "weight":
                v = v * _fan_in(n.rsplit(".", 1)[-1], t.shape) ** -0.5
            out[n] = v.to(t.dtype)
    return out


def load_weights_(model: torch.nn.Module,
                  weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s state in place."""
    state = model.state_dict()
    missing = [n for n, t in state.items()
               if t.is_floating_point() and n not in weights]
    if missing:
        raise KeyError(f"no weights drawn for {missing[:5]}")
    with torch.no_grad():
        for n, t in state.items():
            if t.is_floating_point():
                t.copy_(weights[n])


# ---------------------------------------------------------------------------
# set-up and window timing
# ---------------------------------------------------------------------------

class SetupClock:
    """Set-up split into named parts, on the host clock; ``t0`` is the
    process's start as run.py saw it."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.parts: Dict[str, float] = {}
        self._last = time.perf_counter()
        self.parts["imports"] = self._last - t0

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self._last
        self._last = now

    def total(self) -> float:
        return time.perf_counter() - self.t0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile (0 < q < 1) with linear interpolation."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# spans at module boundaries (trace runs only)
# ---------------------------------------------------------------------------

class Spans:
    """CUDA-event spans recorded by forward hooks of the benchmark's own at
    module boundaries, and by ``mark`` around calls; read once the window
    has closed. On the CPU (tests) the host clock stands in."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.open: Dict[str, list] = {}
        self.pairs: Dict[str, list] = {}
        self.handles = []

    def _stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def begin(self, name: str) -> None:
        self.open.setdefault(name, []).append(self._stamp())

    def end(self, name: str) -> None:
        start = self.open[name].pop()
        self.pairs.setdefault(name, []).append((start, self._stamp()))

    def hook(self, name: str, module: torch.nn.Module) -> None:
        """Span ``name`` around each forward of ``module``."""
        self.handles.append(module.register_forward_pre_hook(
            lambda *_: self.begin(name)))
        self.handles.append(module.register_forward_hook(
            lambda *_: self.end(name)))

    def hook_step(self, model: torch.nn.Module) -> None:
        """Spans "forward" around the model's forward, and "after_forward"
        from its end on; the caller ends the latter once the step returns
        (losses, backward, guard and update)."""
        def forward_done(*_):
            self.end("forward")
            self.begin("after_forward")
        self.handles.append(model.register_forward_pre_hook(
            lambda *_: self.begin("forward")))
        self.handles.append(model.register_forward_hook(forward_done))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def ms(self) -> Dict[str, List[float]]:
        """Each span's durations in ms, in the order recorded."""
        out = {}
        for name, pairs in self.pairs.items():
            if self.cuda:
                out[name] = [a.elapsed_time(b) for a, b in pairs]
            else:
                out[name] = [(b - a) * 1e3 for a, b in pairs]
        return out


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

def _intervals_union(iv: List[tuple]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(prof, window_s: float) -> dict:
    """The traced window's device time by operation, the busy seconds, and
    the longest idle gaps named by the innermost host operation running in
    each. Times in seconds."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False):
            continue            # a range such as an optimizer step's: no work
        if e.device_type == DeviceType.CUDA:
            dev.append((start, end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
    by_name: Dict[str, list] = {}
    for s, e, n in dev:
        rec = by_name.setdefault(n, [0.0, 0])
        rec[0] += (e - s) * 1e-6
        rec[1] += 1
    busy_s = _intervals_union([(s, e) for s, e, _ in dev]) * 1e-6
    gaps = []
    ordered = sorted((s, e) for s, e, _ in dev)
    cur = None
    for s, e in ordered:
        if cur is not None and s > cur:
            gaps.append((s - cur, cur, s))
        cur = e if cur is None else max(cur, e)
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = [(he - hs, hn) for hs, he, hn in host if hs <= mid <= he]
        name = min(inner)[1] if inner else "(no host operation)"
        named.append([name, length * 1e-6])
    return {"kernels": {n: {"s": v[0], "count": v[1]}
                        for n, v in by_name.items()},
            "busy_s": busy_s, "window_s": window_s,
            "idle_gaps": named}


class Trace:
    """``torch.profiler`` over part of the window (CPU and CUDA activity);
    ``start``/``stop`` bracket it, ``result`` reduces it."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self) -> None:
        sync(self.device)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def result(self) -> dict:
        return reduce_trace(self.prof, self.t1 - self.t0)


def kernel_seconds(kernels: Dict[str, dict], *patterns: str) -> float:
    """Device seconds of the kernels whose name holds one of ``patterns``
    as a whole word (the kernel function's name, whatever its return type,
    namespace and template arguments)."""
    words = [re.compile(r"\b" + re.escape(p) + r"\b") for p in patterns]
    return sum(rec["s"] for name, rec in kernels.items()
               if any(w.search(name) for w in words))


def span_mean_ms(rec: dict, loop: str, key: str) -> Optional[float]:
    """The mean over the window of span ``key`` (CUDA events the benchmark
    records at module boundaries), in ms; None in another loop or where
    the span never ran."""
    xs = rec.get("spans_ms", {}).get(key)
    if rec.get("loop") != loop or not xs:
        return None
    return sum(xs) / len(xs)


def idle_pct(rec: dict, loop: str) -> Optional[float]:
    """The device's idle share of the traced window, 100 x (1 - busy_s /
    window_s), busy_s the union of the device operations' intervals in the
    profiler's trace; None without a card or in another loop."""
    if rec.get("platform") != "gpu" or rec.get("loop") != loop \
            or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def mfu_pct(rec: dict, loop: str) -> Optional[float]:
    """The whole request's or step's share of the chip's float32 peak: the
    operations counts/<family>.py gives for every request or step of the
    window after its traced part, over that part's seconds, against the
    published peak (peaks.json); None without a card or in another
    loop."""
    part = rec.get("untraced") or {}
    if rec.get("platform") != "gpu" or rec.get("loop") != loop \
            or not part.get("requests"):
        return None
    rate = part["counts"]["flop"] / part["seconds"]
    return 100.0 * rate / rec["peaks"]["f32_flops"]


def roofline_pct(rec: dict, loop: str, kernels, parts) -> Optional[float]:
    """The share of their roofline that the traced window's launches of
    ``kernels`` reach, in %: the least time they need (the sum over
    ``parts`` of counts/<family>.py's operations over the float32 peak or
    least bytes over the bandwidth, whichever is longer; peaks.json) over
    their device time by kernel name in the profiler's trace. None where
    there is nothing to read: another loop, no card, no such kernel."""
    if rec.get("platform") != "gpu" or rec.get("loop") != loop:
        return None
    seconds = kernel_seconds(rec.get("kernels", {}), *kernels)
    counts = rec.get("traced_counts") or {}
    if seconds <= 0 or not counts:
        return None
    peaks = rec["peaks"]
    least = sum(max(counts[p + "_flop"] / peaks["f32_flops"],
                    counts[p + "_bytes"] / peaks["hbm_bytes_per_s"])
                for p in parts)
    return 100.0 * least / seconds


# ---------------------------------------------------------------------------
# per-layer metrics and the result line
# ---------------------------------------------------------------------------

def per_layer_metrics(workload: str, records: dict) -> Dict[str, dict]:
    """Each per-layer metric of BENCHMARK.json that lists this cell (or
    lists none), read by metrics/<name>.py from the traced run's
    ``records``; a reader that finds nothing returns None and the metric
    is left out."""
    out = {}
    for m in benchmark_spec()["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        reader = load_module("metrics", f"{m['name']}.py")
        value = reader.read(records)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(device, chips: int) -> dict:
    if torch.device(device).type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(chips))
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}


def emit(result: dict, checks: List[dict]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result line as the last line of standard
    output, the checks under the key that comes last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps(line), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
