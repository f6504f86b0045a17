"""Checkpoint / resume over ``torch.save``.

Same methods and rules as multimodal_gar_tpu/train/checkpoint.py (which
keeps orbax checkpoints of the full train state): one file per saved step,
``step_<n>.pt``, holding the model's ``state_dict`` (weights and BatchNorm
statistics), the ``AccumulatingAdam`` state (Adam moments, accumulator,
micro-step and update counts) and the global step; the newest
``max_to_keep`` are kept; ``best.json`` points at the step with the best
``score``. Files are read back with ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional

import torch

from .train_state import TrainState

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_path = os.path.join(self.directory, "best.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.fullmatch, os.listdir(self.directory)) if m)

    def save(self, step: int, state: TrainState,
             metrics: Optional[dict] = None, write: bool = True) -> None:
        """Save ``state`` as step ``step``. Under a mesh every process
        calls it (a sharded optimizer gathers its full state) and only the
        one with ``write`` writes."""
        payload = {"step": int(step), "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
        if not write:
            return
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))       # no half-written checkpoint
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        if metrics:
            self._maybe_update_best(step, metrics)

    def _maybe_update_best(self, step: int, metrics: dict) -> None:
        score = metrics.get("score")
        if score is None:
            return
        best = self.best_info()
        if best is None or score > best.get("score", -1):
            with open(self._best_path, "w") as f:
                json.dump({"step": int(step), "score": float(score),
                           **{k: float(v) for k, v in metrics.items()}}, f)

    def best_info(self) -> Optional[dict]:
        if not os.path.exists(self._best_path):
            return None
        with open(self._best_path) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load the checkpoint of ``step`` (default: the latest) into
        ``state``'s model and optimizer (where it has one) in place; returns
        ``state`` with the saved global step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        if state.optimizer is not None:
            state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def close(self) -> None:
        """Nothing is held open: every save is complete when it returns."""
