"""Observability: metric writers, timers, meters.

Replaces the reference's observability stack (SURVEY.md §5.5): the hardcoded
Neptune run (train_func.py:489-498 — including a leaked API token we obviously
do not reproduce) becomes a pluggable MetricWriter (stdout + JSONL file;
TensorBoard backend slots in when available), and train_utils.Timer (:223-240)
/ pcdet AverageMeter (common_utils.py:262) get clean equivalents.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    """Writes scalar metrics to stdout and an append-only JSONL file."""

    def __init__(self, log_dir: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._f = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        payload = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        payload["step"] = int(step)
        payload["ts"] = time.time()
        if self._f:
            self._f.write(json.dumps(payload) + "\n")
            self._f.flush()
        if self.echo:
            parts = " ".join(f"{k}={v:.4f}" for k, v in payload.items()
                             if k not in ("step", "ts"))
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()


class Timer:
    """Wall-clock iteration/epoch timer (train_utils.py:223-240 equivalent)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._iter = time.time()
        self._epoch = time.time()

    def itertime(self) -> float:
        now = time.time()
        dt = now - self._iter
        self._iter = now
        return dt

    def epochtime(self) -> float:
        now = time.time()
        dt = now - self._epoch
        self._epoch = now
        return dt


class AverageMeter:
    """Running mean (pcdet common_utils.py:262 equivalent)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
