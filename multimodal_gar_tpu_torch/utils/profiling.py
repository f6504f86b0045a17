"""Profiling utilities (utils/profiling.py).

- ``trace(logdir)``: context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (open in chrome://tracing or Perfetto) to ``logdir``.
- ``time_fn``: warm up, then time a callable: on the card between one pair
  of CUDA events (device time: the host may run ahead of the device, so the
  host clock around asynchronous launches reads the wrong thing), on the CPU
  with ``time.perf_counter``.
- ``start_server(port)``: an on-demand capture server for a running
  program, the counterpart of the JAX package's profiler server (torch has
  none): a daemon thread answers ``GET /capture?ms=N`` on localhost by
  recording ``trace`` for N milliseconds of whatever the process runs
  meanwhile, and replies with the trace file's path.
- ``span(name)``: a named span of the program (the train and eval steps,
  the model's branches and layers open them). While a ``torch.profiler``
  records (``trace``, a ``start_server`` capture, any other profile), it
  is a range on the profiler's clock, in the same trace as the kernels it
  encloses, and a record of its host time, its device time (CUDA events
  on the current stream) and its place: the enclosing span and the root
  span's sequence number (one per request or micro-step). Otherwise it
  costs one check. ``span_records()`` reads the records (the newest
  ``SPAN_CAPACITY``, and how many were dropped), ``reset_spans()`` empties
  them.

``time_fn``, ``trace`` and ``start_server`` run on the card unless the
caller passes ``device="cpu"``; a card that is not there raises
(``utils.device.resolve_device``), so a number taken by the host clock is
never mistaken for device time.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from multimodal_gar_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace", device="cuda"):
    """Profile the body on the host and on ``device`` (the card unless the
    caller passes ``"cpu"``; a card that is not there raises); write
    ``<logdir>/<name>.json`` and yield the ``torch.profiler.profile``
    object (its ``key_averages()`` are valid after the block)."""
    on_card = resolve_device(device).type == "cuda"
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            device="cuda", **kwargs) -> Tuple[float, Any]:
    """Returns (seconds_per_call, last_output) of ``fn(*args, **kwargs)``
    over ``iters`` calls after ``warmup`` calls. ``device``: where ``fn``
    runs: a CUDA device (the default; one that is not there raises) is timed
    by events on its current stream, ``"cpu"`` by the host clock."""
    device = resolve_device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        return (time.perf_counter() - t0) / iters, out
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) * 1e-3 / iters, out


def start_server(port: int = 9999, logdir: str = "profiles",
                 device="cuda") -> ThreadingHTTPServer:
    """Serve captures on ``localhost:port`` from a daemon thread and return
    the server (``server.server_address[1]`` is the port, useful with
    ``port=0``; stop it with ``server.shutdown()`` and
    ``server.server_close()``).

    ``GET /capture?ms=N`` (N defaults to 200) records :func:`trace` of the
    host and ``device`` for N milliseconds, whatever the process's other
    threads launch meanwhile (the card's kernels are recorded
    device-wide), writes ``<logdir>/capture_<k>.json`` and answers
    ``{"trace": path, "ms": N}``. One capture runs at a time; a capture
    requested while the process is inside another ``trace`` fails with
    status 500 and the profiler's message. Other paths answer 404."""
    device = resolve_device(device)
    lock = threading.Lock()
    counter = itertools.count()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path != "/capture":
                self._reply(404, {"error": f"no {url.path}: GET /capture"})
                return
            try:
                ms = float(urllib.parse.parse_qs(url.query).get(
                    "ms", ["200"])[0])
                with lock:
                    name = f"capture_{next(counter)}"
                    with trace(logdir, name=name, device=device):
                        time.sleep(ms / 1000.0)
            except Exception as err:   # the client hears why
                self._reply(500, {"error": repr(err)})
                return
            self._reply(200, {"trace": os.path.abspath(
                os.path.join(logdir, f"{name}.json")), "ms": ms})

        def _reply(self, status: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args) -> None:   # no line per request
            pass

    server = ThreadingHTTPServer(("localhost", port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="profiler-server",
                     daemon=True).start()
    return server


# ---------------------------------------------------------------------------
# program spans
# ---------------------------------------------------------------------------

# the records a capture keeps: a long start_server capture drops the oldest
SPAN_CAPACITY = 8192

# whether a torch profiler records in this process (read per span: a
# module-level name, so that a test can turn the spans off under a profiler)
_profiler_enabled = torch._C._autograd._profiler_enabled


class SpanRecords(NamedTuple):
    """``records``: one dict per closed span, in the order the spans were
    opened, with ``name``, ``parent`` (the enclosing span's name, None for
    a root), ``root`` (the root span's sequence number, shared by all spans
    of one request or micro-step), ``host_ms`` and ``device_ms`` (None where
    CUDA was not initialised); ``dropped``: records dropped for the
    capacity since the last ``reset_spans``."""
    records: List[dict]
    dropped: int


class _Record:
    __slots__ = ("name", "parent", "root", "t0", "t1", "e0", "e1",
                 "device_ms")

    def __init__(self, name: str, parent: Optional["_Record"], root: int):
        self.name, self.parent, self.root = name, parent, root
        self.t1 = self.e0 = self.e1 = self.device_ms = None


class _SpanLog:
    """The process's span records, the count dropped, the root sequence and
    each thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.roots = itertools.count(1)
        self.records: collections.deque = collections.deque(
            maxlen=SPAN_CAPACITY)
        self.dropped = 0

    def stack(self) -> List[_Record]:
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack

    def open(self, name: str) -> _Record:
        stack = self.stack()
        parent = stack[-1] if stack else None
        rec = _Record(name, parent,
                      parent.root if parent else next(self.roots))
        with self.lock:
            if len(self.records) == SPAN_CAPACITY:
                self.dropped += 1
            self.records.append(rec)
        stack.append(rec)
        rec.t0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            rec.e0 = torch.cuda.Event(enable_timing=True)
            rec.e0.record()
        return rec

    def close(self, rec: _Record) -> None:
        if rec.e0 is not None:
            rec.e1 = torch.cuda.Event(enable_timing=True)
            rec.e1.record()
        rec.t1 = time.perf_counter_ns()
        stack = self.stack()
        if stack and stack[-1] is rec:
            stack.pop()


_SPANS = _SpanLog()


class span:
    """``with span(name):`` the body as a program span (module docstring).
    It never synchronises: the device times are read by ``span_records``.
    Nesting follows the calling thread's open spans."""

    __slots__ = ("name", "_rec", "_range")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            self._rec = _SPANS.open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            _SPANS.close(self._rec)
            self._range.__exit__(*exc)
            self._rec = None


def span_records() -> SpanRecords:
    """The closed spans' records (``SpanRecords``), the device times read
    after one synchronisation where any is still to be read."""
    with _SPANS.lock:
        closed = [r for r in _SPANS.records if r.t1 is not None]
        dropped = _SPANS.dropped
    if any(r.e1 is not None and r.device_ms is None for r in closed):
        torch.cuda.synchronize()
        for r in closed:
            if r.e1 is not None and r.device_ms is None:
                r.device_ms = r.e0.elapsed_time(r.e1)
                r.e0 = r.e1 = None
    return SpanRecords(
        [{"name": r.name, "parent": r.parent.name if r.parent else None,
          "root": r.root, "host_ms": (r.t1 - r.t0) * 1e-6,
          "device_ms": r.device_ms} for r in closed], dropped)


def reset_spans() -> None:
    """Empty the records and the dropped count (root numbers go on)."""
    with _SPANS.lock:
        _SPANS.records.clear()
        _SPANS.dropped = 0


# ---------------------------------------------------------------------------
# program counters
# ---------------------------------------------------------------------------

_COUNTERS_LOCK = threading.Lock()
_COUNTERS: dict = {}


def recording() -> bool:
    """Whether a profiler records, and so spans and counters with it."""
    return _profiler_enabled()


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a tensor of one element on any device) to
    counter ``name`` while a profiler records; otherwise one check. A
    tensor is summed on its device, never read here."""
    if not _profiler_enabled():
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().reshape(()).to(torch.int64)
    with _COUNTERS_LOCK:
        _COUNTERS[name] = _COUNTERS[name] + value if name in _COUNTERS \
            else value


def counter_values() -> dict:
    """Each counter's total as an int (one synchronisation where a total
    lies on the card)."""
    with _COUNTERS_LOCK:
        items = list(_COUNTERS.items())
    return {k: int(v) for k, v in items}


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.clear()
