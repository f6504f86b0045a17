"""Profiling utilities (utils/profiling.py).

- ``trace(logdir)``: context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (open in chrome://tracing or Perfetto) to ``logdir``.
- ``time_fn``: warm up, then time a callable: on the card between one pair
  of CUDA events (device time: the host may run ahead of the device, so the
  host clock around asynchronous launches reads the wrong thing), on the CPU
  with ``time.perf_counter``.

Both run on the card unless the caller passes ``device="cpu"``; a card that
is not there raises (``utils.device.resolve_device``), so a number taken by
the host clock is never mistaken for device time.

The JAX package's ``start_server`` (a live-capture profiler server) has no
counterpart in torch and is left out.
"""
from __future__ import annotations

import contextlib
import os
import time
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
