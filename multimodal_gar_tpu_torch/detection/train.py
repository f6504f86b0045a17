"""The detector zoo's train step (detection/train.py): forward, loss,
gradients and one update of ``clip_by_global_norm(10)`` then AdamW(3e-3,
weight decay 0.01) on every parameter, BatchNorm scales and biases
included.

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from ..models.layers import seed_dropout
from ..parallel.mesh import (all_reduce_grads, attach, axis_size,
                             batch_denominator, shard_batch)
from .bev import cudnn_autotuned
from .detectors import DetBatch


@dataclasses.dataclass
class DetTrainState:
    """The optimizer and the number of steps taken."""
    optimizer: torch.optim.AdamW
    params: List[torch.nn.Parameter]
    clip_norm: float
    step: int = 0


def create_det_train_state(model: torch.nn.Module,
                           learning_rate: float = 3e-3,
                           weight_decay: float = 0.01,
                           clip_norm: float = 10.0) -> DetTrainState:
    params = [p for p in model.parameters() if p.requires_grad]
    # optax adamw: b1 0.9, b2 0.999, eps 1e-8, the decay on every parameter
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    return DetTrainState(optimizer=opt, params=params, clip_norm=clip_norm)


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
    clipped AdamW update of ``model`` (in training mode). With a ``mesh``
    the metrics are this rank's; their mean over the ranks
    (``reduce_metrics_mean``) is the global batch's. ``model.loss`` takes
    the mesh's ``batch_denominator``; the model is bound to the mesh
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
        model.train()
        seed_det_generators(model, seed, state.step)
        state.optimizer.zero_grad(set_to_none=False)
        preds = model(batch)
        losses = model.loss(preds, batch, denominator=denominator)
        with cudnn_autotuned():          # the BEV convs' backward too
            losses["loss"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in state.params]
        if mesh is not None:
            grads = all_reduce_grads(grads, mesh)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        with torch.no_grad():
            norm = torch.sqrt(sum((torch.where(finite, g, 0.0) ** 2).sum()
                                  for g in grads))
            # optax.clip_by_global_norm: g * max / norm where norm >= max
            scale = torch.where(norm < state.clip_norm, 1.0,
                                state.clip_norm / norm)
            scale = torch.where(finite, scale, 0.0)
            for p, g in zip(state.params, grads):
                p.grad = torch.where(finite, g * scale, 0.0)
        state.optimizer.step()
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
