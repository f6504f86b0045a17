"""Faults planted underneath a run's timed path, to show that the
comparison catches them: each is a context manager that patches the
program for as long as it is open.

- ``answer_altered``: an eval request's first pose head gives actor 0's
  probabilities to the wrong classes, where the model produces them.
- ``state_unchanged_mgar``: Adam never applies the accumulated gradient
  (the optimizer's state and the weights stay as they were).

Used by tests/test_h100bench_reference.py at tiny sizes on the CPU and by
``calibrate.py --fault`` at the cell's own sizes on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def answer_altered():
    from multimodal_gar_tpu_torch.train import train_state
    make = train_state.make_eval_step

    def broken(model):
        step = make(model)

        def altered(batch):
            out = step(batch)
            pose = list(out.pose)
            pose[0] = pose[0].clone()
            pose[0][:, 0] = pose[0][:, 0].roll(1, dims=-1)
            return dataclasses.replace(out, pose=tuple(pose))
        return altered
    return _patched(train_state, "make_eval_step", broken)


def state_unchanged_mgar():
    from multimodal_gar_tpu_torch.train.train_state import AccumulatingAdam
    real = AccumulatingAdam.update

    def no_step(self, grads):
        adam_step = self.adam.step
        self.adam.step = lambda *a, **k: None
        try:
            return real(self, grads)
        finally:
            self.adam.step = adam_step
    return _patched(AccumulatingAdam, "update", no_step)


FAULTS = {"answer_altered": answer_altered,
          "state_unchanged_mgar": state_unchanged_mgar}
