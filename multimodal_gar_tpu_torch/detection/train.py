"""The detector zoo's train step (detection/train.py): forward, loss,
gradients and one update of ``clip_by_global_norm(10)`` then AdamW(3e-3,
weight decay 0.01) on every parameter, BatchNorm scales and biases
included. ``create_det_train_state(..., optimizer="adam_onecycle")`` takes
OpenPCDet's ``adam_onecycle`` instead (tools/train_utils/optimization:
``OptimWrapper`` + ``OneCycle``, ``OneCycleConfig``): Adam with betas
(beta1, 0.99), the weight decay applied to every parameter as
``p *= 1 - wd * lr`` before each Adam step, and a learning rate and beta1
cycled by step. The clipping stays the port's optax form (OpenPCDet's
``clip_grad_norm_`` adds 1e-6 to the norm).

As in the JAX step: BatchNorm statistics move in the training forward;
when any gradient is not finite, every gradient is zeroed and the AdamW
step is still taken (the moments decay and the weights decay), and
``nonfinite_grads`` says so. Dropout and the RoI sampler draw from
generators of the model's own, reseeded from (seed, step) before each step.

With a ``mesh`` (parallel/mesh.py, data axis only) the step is one rank's
share of a data-parallel step over ``shard_det_batch``'s block: the
BatchNorms and the loss denominators that span the batch count over the
data axis, and the gradients are averaged over it after the backward and
before the guard and the clipping, so that every rank takes the same
decisions and the same update.

The step opens the program spans of every train step (utils/profiling.py:
``span``; train/train_state.py names them alike): ``train_step`` over
``train_step.forward``, ``.losses``, ``.backward``, ``.guard`` (the
finiteness check, the gradient norm and the clipping) and ``.update``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.layers import seed_dropout
from ..parallel.mesh import (all_reduce_grads, attach, axis_size,
                             batch_denominator, shard_batch)
from ..utils.profiling import span
from .bev import cudnn_autotuned
from .detectors import DetBatch


@dataclasses.dataclass(frozen=True)
class OneCycleConfig:
    """OpenPCDet's ``OneCycle`` (tools/train_utils/optimization/
    learning_schedules_fastai.py): over ``total_steps`` the learning rate
    rises from ``lr_max / div_factor`` to ``lr_max`` by a half cosine until
    ``pct_start`` of the steps, then falls to ``lr_max / div_factor / 1e4``;
    beta1 falls from ``moms[0]`` to ``moms[1]`` and rises back. Step k of
    the run uses the values of step k (pcdet steps the schedule before each
    iteration)."""
    total_steps: int
    lr_max: float = 0.01
    moms: tuple = (0.95, 0.85)
    div_factor: float = 10.0
    pct_start: float = 0.4


def _annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def one_cycle_at(cfg: OneCycleConfig, step: int) -> tuple:
    """(learning rate, beta1) of ``step`` (pcdet's LRSchedulerStep: each
    phase from int(start * total) to the next phase's start)."""
    low = cfg.lr_max / cfg.div_factor
    mid = int(cfg.pct_start * cfg.total_steps)
    if step < mid:
        pct = step / mid
        return (_annealing_cos(low, cfg.lr_max, pct),
                _annealing_cos(cfg.moms[0], cfg.moms[1], pct))
    pct = (step - mid) / (cfg.total_steps - mid)
    return (_annealing_cos(cfg.lr_max, low / 1e4, pct),
            _annealing_cos(cfg.moms[1], cfg.moms[0], pct))


@dataclasses.dataclass
class DetTrainState:
    """The optimizer and the number of steps taken; ``one_cycle`` and
    ``weight_decay`` where the optimizer is ``adam_onecycle``."""
    optimizer: torch.optim.Optimizer
    params: List[torch.nn.Parameter]
    clip_norm: float
    step: int = 0
    one_cycle: Optional[OneCycleConfig] = None
    weight_decay: float = 0.0


def create_det_train_state(model: torch.nn.Module,
                           learning_rate: float = 3e-3,
                           weight_decay: float = 0.01,
                           clip_norm: float = 10.0,
                           optimizer: str = "adamw",
                           one_cycle: Optional[OneCycleConfig] = None
                           ) -> DetTrainState:
    """AdamW at ``learning_rate`` (the JAX package's), or with
    ``optimizer="adam_onecycle"`` OpenPCDet's one-cycle Adam on the
    schedule ``one_cycle`` (``learning_rate`` is then not read)."""
    params = [p for p in model.parameters() if p.requires_grad]
    if optimizer == "adamw":
        # optax adamw: b1 0.9, b2 0.999, eps 1e-8, the decay on every
        # parameter
        opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
        return DetTrainState(optimizer=opt, params=params,
                             clip_norm=clip_norm)
    if optimizer != "adam_onecycle" or one_cycle is None:
        raise ValueError(f"optimizer {optimizer!r}: adamw, or adam_onecycle "
                         "with a one_cycle schedule")
    lr, beta1 = one_cycle_at(one_cycle, 0)
    # OptimWrapper(partial(optim.Adam, betas=(0.9, 0.99)), true_wd=True,
    # bn_wd=True): torch's Adam without its own decay
    opt = torch.optim.Adam(params, lr=lr, betas=(beta1, 0.99), eps=1e-8,
                           weight_decay=0.0)
    return DetTrainState(optimizer=opt, params=params, clip_norm=clip_norm,
                         one_cycle=one_cycle, weight_decay=weight_decay)


def _optimizer_step(state: DetTrainState) -> None:
    """One update: AdamW's, or the one-cycle step's values for
    ``state.step``, the decoupled decay, then Adam."""
    if state.one_cycle is not None:
        lr, beta1 = one_cycle_at(state.one_cycle, state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
            group["betas"] = (beta1, group["betas"][1])
        with torch.no_grad():
            torch._foreach_mul_(state.params, 1.0 - state.weight_decay * lr)
    state.optimizer.step()


def seed_det_generators(model: torch.nn.Module, seed: int, step: int) -> None:
    """Reseed the model's dropout (``seed_dropout``) and, where it has one,
    its RoI sampler's generator for step ``step`` of a run seeded
    ``seed``."""
    seed_dropout(model, seed, step)
    gen = getattr(model, "sampler_generator", None)
    if gen is not None:
        lo, hi = np.random.SeedSequence([int(seed), int(step), 7]
                                        ).generate_state(2)
        gen.manual_seed((int(hi) << 32) | int(lo))


def make_det_train_step(model: torch.nn.Module, state: DetTrainState,
                        seed: int = 0, mesh=None
                        ) -> Callable[[DetBatch], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``: one fused forward + loss + backward +
    clipped AdamW (or one-cycle Adam) update of ``model`` (in training
    mode). With a ``mesh`` the metrics are this rank's; their mean over the
    ranks (``reduce_metrics_mean``) is the global batch's. ``model.loss``
    takes the mesh's ``batch_denominator``; the model is bound to the mesh
    (``attach``), or unbound without one. At ``DetectorConfig.dtype``
    bfloat16 the trunk trains in bf16 as it serves (detection/detectors.py)
    with float32 parameters and AdamW."""
    if mesh is not None and axis_size(mesh, "fsdp") > 1:
        raise NotImplementedError(
            "the detector step shards the batch only (fsdp = 1): its "
            "AdamW holds every parameter whole")
    attach(model, mesh)
    denominator = batch_denominator(mesh)

    def step(batch: DetBatch) -> Dict[str, torch.Tensor]:
        with span("train_step"):
            model.train()
            seed_det_generators(model, seed, state.step)
            state.optimizer.zero_grad(set_to_none=False)
            with span("train_step.forward"):
                preds = model(batch)
            with span("train_step.losses"):
                losses = model.loss(preds, batch, denominator=denominator)
            with span("train_step.backward"):
                with cudnn_autotuned():      # the BEV convs' backward too
                    losses["loss"].backward()
                grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                         for p in state.params]
                if mesh is not None:
                    grads = all_reduce_grads(grads, mesh)
            with span("train_step.guard"), torch.no_grad():
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads]).all()
                norm = torch.sqrt(sum((torch.where(finite, g, 0.0) ** 2).sum()
                                      for g in grads))
                # optax.clip_by_global_norm: g * max / norm where norm >= max
                scale = torch.where(norm < state.clip_norm, 1.0,
                                    state.clip_norm / norm)
                scale = torch.where(finite, scale, 0.0)
                for p, g in zip(state.params, grads):
                    p.grad = torch.where(finite, g * scale, 0.0)
            with span("train_step.update"):
                _optimizer_step(state)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["nonfinite_grads"] = 1.0 - finite.to(torch.float32)
        return metrics

    return step


def shard_det_batch(batch: DetBatch, mesh) -> DetBatch:
    """This rank's block of the batch axis over the mesh's 'data' axis:
    the rule of the MGAR path (parallel/mesh.py: ``shard_batch``).

    ``data/registry.py: det_batches(rank=, world=)`` shards otherwise: it
    deals samples by stride (``idx[rank::world]``), which gives a step the
    same set of samples in another order within the batch. The step is
    invariant under that permutation up to the order of its sums."""
    return shard_batch(batch, mesh)
