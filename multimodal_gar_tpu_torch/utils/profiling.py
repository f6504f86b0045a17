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

All run on the card unless the caller passes ``device="cpu"``; a card that
is not there raises (``utils.device.resolve_device``), so a number taken by
the host clock is never mistaken for device time.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Tuple

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
