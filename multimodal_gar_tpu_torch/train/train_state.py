"""Optimizer, gradient accumulation and the train / eval steps
(train/train_state.py:36-118).

- ``make_optimizer``: Adam (eps 1e-8) with the staircase decay
  ``lr * gamma ** (updates // max(steps_per_epoch // grad_accum, 1))``,
  counted in applied updates, behind k-step accumulation that applies the
  mean of k gradients on every k-th call (``optax.MultiSteps``).
- ``make_train_step``: forward in training mode, ``compute_losses``,
  backward, a non-finite guard (a micro-step whose gradients are not all
  finite contributes zeros and still counts), the accumulation. BatchNorm
  running statistics move on every micro-step. Dropout draws under a seed
  made of the run's seed and the global micro-step (``fold_in(PRNGKey(seed),
  state.step)`` in the JAX package), on a generator of the model's own: two
  runs agree, a resumed run goes on as the uninterrupted one would, and
  torch's global stream is left alone.
- With a ``mesh`` (parallel/mesh.py) the step is one rank's share of a
  data-parallel step: the forward's BatchNorms and loss denominators count
  over the mesh's data axis, and the gradients are reduced right after
  ``torch.autograd.grad`` and before the guard, so that every rank takes
  the same guard decision. The step does not go through ``.backward()``
  and DistributedDataParallel: their reducer hooks never fire on
  ``autograd.grad``, which would leave the gradients local.
- ``make_eval_step``: the eval forward under inference mode, at either
  ``model.dtype``; ``make_train_step`` trains at either, the parameters,
  gradients and Adam in float32.
- Both steps open program spans (utils/profiling.py: ``span``), read
  while a profiler records: ``eval_step``; ``train_step`` around
  ``train_step.forward``, ``.losses``, ``.backward`` (with the gradients'
  all-reduce under a mesh), ``.guard`` and ``.update``.

The port's model holds its own weights, so a step takes only the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..models.layers import seed_dropout
from ..models.mgar import MGAR
from ..parallel.mesh import (agree_finite, all_reduce_grads, attach,
                             batch_denominator)
from ..types import Batch, ModelOutputs
from ..utils.profiling import span
from .losses import compute_losses, total_loss


class AccumulatingAdam:
    """``optax.MultiSteps(optax.adam(exponential_decay(...)), k)`` over the
    parameters that require grad.

    ``update(grads)`` folds one micro-step's gradients into the running
    mean ``acc + (g - acc) / (n + 1)`` and, on every k-th call, applies
    Adam to the mean at the decayed learning rate and resets it.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, steps_per_epoch: int, grad_accum: int,
                 gamma: float):
        self.params: List[torch.nn.Parameter] = [
            p for p in params if p.requires_grad]
        self.base_lr = learning_rate
        self.gamma = gamma
        self.k = max(grad_accum, 1)
        self.transition = max(steps_per_epoch // self.k, 1)
        self.adam = torch.optim.Adam(self.params, lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0              # micro-steps since the last update
        self.updates = 0                # applied updates

    @property
    def learning_rate(self) -> float:
        """The rate of the next applied update."""
        return self.base_lr * self.gamma ** (self.updates // self.transition)

    def update(self, grads: List[torch.Tensor]) -> bool:
        """Accumulate one micro-step; True when it applied an update."""
        n = self.mini_step
        with torch.no_grad():
            for acc, g in zip(self.acc, grads):
                acc.add_((g - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        for group in self.adam.param_groups:
            group["lr"] = self.learning_rate
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.clone()
        self.adam.step()
        for p, acc in zip(self.params, self.acc):
            p.grad = None
            acc.zero_()
        self.mini_step = 0
        self.updates += 1
        return True

    def state_dict(self) -> Dict[str, object]:
        """Everything a resumed run needs, as tensors, lists and ints: the
        Adam moments and the accumulator in the order of ``params`` (zeros
        before the first update), the micro-steps since the last update and
        the number of applied updates (Adam's step count: bias correction
        and the decay schedule both follow it)."""
        def moment(p, key):
            state = self.adam.state.get(p)
            return (state[key] if state else torch.zeros_like(p)).clone()
        return {"exp_avg": [moment(p, "exp_avg") for p in self.params],
                "exp_avg_sq": [moment(p, "exp_avg_sq") for p in self.params],
                "acc": [a.clone() for a in self.acc],
                "mini_step": self.mini_step, "updates": self.updates}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore :meth:`state_dict`'s output in place (tensors are copied
        to the parameters' device)."""
        for key in ("exp_avg", "exp_avg_sq", "acc"):
            if len(state[key]) != len(self.params) or any(
                    t.shape != p.shape
                    for t, p in zip(state[key], self.params)):
                raise ValueError(f"optimizer state {key!r} does not fit the "
                                 "trainable parameters")
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])
        self.adam.state.clear()
        with torch.no_grad():
            for i, p in enumerate(self.params):
                self.acc[i].copy_(state["acc"][i])
                if self.updates:
                    self.adam.state[p] = {
                        "step": torch.tensor(float(self.updates)),
                        "exp_avg": state["exp_avg"][i].to(p).clone(),
                        "exp_avg_sq": state["exp_avg_sq"][i].to(p).clone()}


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds and a stage hook sees: the model (weights and
    BatchNorm statistics), its optimizer and the global micro-step."""
    model: MGAR
    optimizer: Optional[AccumulatingAdam]   # None where only the model is read
    step: int = 0


def make_optimizer(params: Iterable[torch.nn.Parameter], stage,
                   steps_per_epoch: int, grad_accum: int,
                   gamma: float) -> AccumulatingAdam:
    """Adam with per-epoch ``gamma ** epoch`` decay and k-step gradient
    accumulation; ``stage``: multimodal_gar_tpu_torch.config.StageConfig."""
    return AccumulatingAdam(params, stage.learning_rate, steps_per_epoch,
                            grad_accum, gamma)


def make_train_step(model: MGAR, optimizer: AccumulatingAdam,
                    loss_name: str, needs_eig: bool = False, *,
                    state: Optional[TrainState] = None, seed: int = 0,
                    mesh=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """One micro-step: training forward, all losses, gradients, the
    non-finite guard and the accumulating update. Returns the metrics:
    every loss term, ``loss`` and ``nonfinite_grads`` (1.0 when this
    micro-step's gradients were zeroed).

    The step's dropout is seeded by (``seed``, ``state.step``): the caller
    keeps ``state.step`` at the count of micro-steps taken so far, as
    ``run_training`` does. Without a ``state`` the function counts its own
    calls from 0.

    ``mesh``: the step runs on this rank's block of the global batch
    (``shard_batch``) with ``optimizer`` as ``shard_train_state`` left it;
    the metrics are this rank's, and their mean over the ranks
    (``reduce_metrics_mean``) is the global batch's. The step binds the
    model's BatchNorms and dropouts to the mesh (``attach``) and passes
    its losses the mesh's ``batch_denominator``; without a mesh it unbinds
    what an earlier step bound, so that it is local. A bfloat16 model
    (``model.dtype: bfloat16``) trains as the JAX package's does: float32
    parameters, gradients and optimizer, the modules casting at their
    points of use."""
    attach(model, mesh)
    denominator = batch_denominator(mesh)
    if state is None:
        own = state = TrainState(model=model, optimizer=optimizer)
    else:
        own = None

    def step_fn(batch: Batch, e_hat: Optional[torch.Tensor] = None,
                e_count: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        with span("train_step"):
            model.train()
            seed_dropout(model, seed, state.step)
            if own is not None:
                own.step += 1
            with span("train_step.forward"):
                out = model(batch)
            with span("train_step.losses"):
                losses = compute_losses(
                    out, batch, e_hat=e_hat if needs_eig else None,
                    e_count=e_count if needs_eig else None,
                    denominator=denominator)
                loss = total_loss(losses, loss_name)
            with span("train_step.backward"):
                grads = torch.autograd.grad(loss, optimizer.params,
                                            allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(optimizer.params, grads)]
                if mesh is not None:
                    grads = all_reduce_grads(grads, mesh)
            with span("train_step.guard"):
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads]).all()
                if mesh is not None:
                    finite = agree_finite(finite, mesh)
                grads = [torch.where(finite, g, 0.0) for g in grads]
            with span("train_step.update"):
                optimizer.update(grads)
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["loss"] = loss.detach()
            metrics["nonfinite_grads"] = 1.0 - finite.to(torch.float32)
            return metrics

    return step_fn


def make_eval_step(model: MGAR) -> Callable[[Batch], ModelOutputs]:
    """A function running ``model``'s eval forward under inference mode."""

    def eval_fn(batch: Batch) -> ModelOutputs:
        with span("eval_step"):
            model.eval()
            with torch.inference_mode():
                return model(batch)
    return eval_fn
