"""The training loop: staged training + per-epoch JRDB eval + best ckpt.

Capability parity with reference train_func.py:67-557 (train_net + the
module-level script), as multimodal_gar_tpu/train/loop.py has it: two-stage
Adam training, per-epoch evaluation through the JRDB-Act AP harness,
best-checkpoint selection on activity_AP * grouping_AP (grouping_AP alone
for the L_bce stage, train_func.py:317-320), all metric logging. The model
is built on ``device`` and every batch moves there with ``Batch.to``.

Under ``torchrun`` (a process group of more than one process) the loop
runs one process per card on a ('data', 'fsdp') mesh (parallel/mesh.py):
each process trains on its block of every global batch, evaluates its
shard of the validation split, and process 0 alone writes the logs,
result files and checkpoints.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..config import Config
from ..data.jrdb import JRDBActDataset
from ..data.pipeline import DataPipeline
from ..eval.evaluator import evaluate_epoch
from ..models import MGAR
from ..models.i3d_convert import load_i3d_checkpoint
from ..models.layers import compute_dtype
from ..parallel.mesh import axis_rank, axis_size, make_mesh, shard_train_state
from ..parallel.multihost import reduce_metrics_mean
from ..utils.device import resolve_device
from ..utils.metrics import MetricWriter, Timer
from .checkpoint import CheckpointManager
from .train_state import (TrainState, make_eval_step, make_optimizer,
                          make_train_step)


def _build_model(cfg: Config, device: torch.device) -> MGAR:
    model = MGAR(cfg, device=device,
                 generator=torch.Generator().manual_seed(cfg.train.seed))
    if cfg.model.rgb.i3d_checkpoint and model.rgb_backbone is not None:
        # Kinetics-pretrained I3D weights over the seeded draw (reference
        # gat_model.py:987-991)
        load_i3d_checkpoint(model, cfg.model.rgb.i3d_checkpoint)
    return model


class _Layout:
    """Where this process stands on the mesh that ``make_mesh(cfg.mesh)``
    lays over the process group (rank = data rank * fsdp + fsdp rank).
    There is a mesh where ``use_mesh`` holds and a process group of more
    than one process is initialised (``__main__`` under torchrun); without
    one, this is data rank 0 of 1."""

    def __init__(self, cfg: Config, use_mesh: bool):
        self.cfg = cfg
        self.active = use_mesh and dist.is_available() \
            and dist.is_initialized() and dist.get_world_size() > 1
        world = dist.get_world_size() if self.active else 1
        rank = dist.get_rank() if self.active else 0
        fsdp = max(cfg.mesh.fsdp, 1) if self.active else 1
        self.data = world // fsdp
        self.rank, self.fsdp_rank = divmod(rank, fsdp)
        self.writes = rank == 0
        if cfg.train.batch_size % self.data:
            raise ValueError(f"train.batch_size {cfg.train.batch_size} does "
                             f"not split over {self.data} data ranks")
        self.batch_size = cfg.train.batch_size // self.data

    def mesh(self, device: torch.device):
        """The mesh (None without one); made after the pipelines, whose
        decode workers fork before anything touches the card."""
        if not self.active:
            return None
        mesh = make_mesh(self.cfg.mesh, device)
        assert (axis_size(mesh, "data"), axis_rank(mesh, "data")) \
            == (self.data, self.rank)
        return mesh

    def eval_shard(self):
        return (self.rank, self.fsdp_rank == 0) if self.active else None


def _val_pipeline(cfg: Config, val_ds, layout: _Layout) -> DataPipeline:
    # drop_last=False + in-pipeline padding: the remainder batch is padded
    # to the full batch shape. The decode workers serve evaluation too (the
    # JAX package's eval entry point decodes in its one producer thread).
    # Sharded as the training pipeline, but without drop_last every shard
    # keeps its last batches: the evaluator merges the frames and the
    # padded rows, all-invalid, add none.
    return DataPipeline(val_ds, layout.batch_size, shuffle=False,
                        drop_last=False, num_workers=cfg.train.num_workers,
                        shard_index=layout.rank, shard_count=layout.data)


def _on_device(batches, device):
    for batch in batches:
        yield batch.to(device)


def run_training(cfg: Config, workdir: str,
                 train_ds: Optional[JRDBActDataset] = None,
                 val_ds: Optional[JRDBActDataset] = None,
                 max_steps_per_epoch: Optional[int] = None,
                 resume: bool = True,
                 on_stage_start: Optional[Callable[[int, TrainState], None]] = None,
                 on_stage_end: Optional[Callable[[int, TrainState], None]] = None,
                 device="cuda", use_mesh: bool = True) -> Dict[str, float]:
    """Run all configured stages; returns the final eval metrics.

    ``resume=True`` restores the latest checkpoint in the workdir (if any)
    into the first trained stage, and training goes on after the epochs it
    already holds. Runs on ``device``: the card unless the caller asks for
    ``"cpu"``; without a card the default raises at once. With
    ``use_mesh`` and an initialised process group of more than one
    process, the run is data parallel over ``cfg.mesh`` (module
    docstring). At ``model.dtype: bfloat16`` the model computes in bf16
    and its checkpoints hold float32 parameters, which ``run_eval`` serves
    at either dtype.
    """
    compute_dtype(cfg.model.dtype)
    device = resolve_device(device)
    layout = _Layout(cfg, use_mesh)
    caps = cfg.model.lidar.max_voxels_per_stage
    train_ds = train_ds or JRDBActDataset(cfg.data, "train", training=True,
                                          rulebook_caps=caps)
    val_ds = val_ds or JRDBActDataset(cfg.data, "test", training=False,
                                      rulebook_caps=caps)

    any_eig = any(stage.loss == "L_g" for stage in cfg.train.stages)
    # both pipelines before the model: with train.num_workers > 0 their
    # constructors fork the decode workers, and a child forked from a
    # process that has initialised CUDA must never touch it. Forking first
    # keeps the workers clear of the card's context altogether (they run
    # numpy only, data/decode_pool.py).
    # Under a mesh each process reads batches of b = batch_size / data
    # rows, shard r of data: its k-th batch is the pipeline's batch
    # k * data + r at size b, rows [(k * data + r) * b, (k * data + r + 1)
    # * b) of the epoch's order, which is exactly the r-th block of the
    # single process's batch k at the global size; steps_per_epoch is the
    # single process's (floor(floor(n / b) / data) = floor(n / (b * data))).
    train_pipe = DataPipeline(train_ds, layout.batch_size,
                              shuffle=cfg.train.shuffle, seed=cfg.train.seed,
                              with_eig=any_eig,
                              num_workers=cfg.train.num_workers,
                              shard_index=layout.rank,
                              shard_count=layout.data)
    val_pipe = _val_pipeline(cfg, val_ds, layout)

    mesh = layout.mesh(device)
    writer = MetricWriter(os.path.join(workdir, "logs")) \
        if layout.writes else None
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    timer = Timer()

    model = _build_model(cfg, device)
    steps_per_epoch = train_pipe.steps_per_epoch()
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    metrics: Dict[str, float] = {}
    global_step = 0
    restored = False
    # the model is carried across stages (train_func.py:550-556: the
    # reference keeps the trained model and only rebuilds Adam)
    for stage_idx, stage in enumerate(cfg.train.stages):
        if stage.epochs <= 0:
            continue
        optimizer = make_optimizer(model.parameters(), stage, steps_per_epoch,
                                   cfg.train.grad_accum_steps,
                                   cfg.train.lr_decay_gamma)
        state = TrainState(model=model, optimizer=optimizer,
                           step=global_step)
        if resume and not restored and ckpt.latest_step() is not None:
            state = ckpt.restore(state)
            global_step = state.step
            print(f"resumed from checkpoint at step {global_step}", flush=True)
            restored = True
        if mesh is not None:
            state = shard_train_state(state, mesh)
            optimizer = state.optimizer
        if on_stage_start is not None:
            on_stage_start(stage_idx, state)
        needs_eig = stage.loss == "L_g"
        train_step = make_train_step(model, optimizer, stage.loss,
                                     needs_eig=needs_eig, state=state,
                                     seed=cfg.train.seed, mesh=mesh)
        eval_step = make_eval_step(model)

        # fast-forward past already-trained epochs after a resume. The
        # restored global step counts epochs across ALL prior stages, so
        # subtract the epochs belonging to stages before this one — gating
        # on stage 0 alone would re-train a later stage's completed epochs
        # (double-training restored weights and shifting the LR schedule).
        start_epoch = 0
        if restored:
            done_epochs = global_step // max(steps_per_epoch, 1)
            prior_epochs = sum(s.epochs for s in cfg.train.stages[:stage_idx]
                               if s.epochs > 0)
            start_epoch = max(0, min(done_epochs - prior_epochs,
                                     stage.epochs))
        for epoch in range(start_epoch, stage.epochs):
            seconds = {"train_s": 0.0, "eval_s": 0.0, "checkpoint_s": 0.0}
            t0 = time.perf_counter()
            for i, batch in enumerate(train_pipe.epoch(epoch)):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                batch = batch.to(device)
                # eig inputs are precomputed in the pipeline's producer
                # thread (DataPipeline(with_eig=True))
                step_metrics = train_step(
                    batch, e_hat=batch.e_hat if needs_eig else None,
                    e_count=batch.e_count if needs_eig else None)
                global_step += 1
                state.step = global_step
                if global_step % cfg.train.log_every_steps == 0:
                    logged = reduce_metrics_mean(
                        {k: float(v) for k, v in step_metrics.items()})
                    if writer is not None:
                        writer.write(global_step, logged, prefix="train/")
            seconds["train_s"] = time.perf_counter() - t0

            if (epoch + 1) % cfg.train.eval_every_epochs == 0:
                t0 = time.perf_counter()
                metrics = evaluate_epoch(
                    eval_step, _on_device(val_pipe.epoch(0), device),
                    result_dir=os.path.join(workdir, "results",
                                            f"s{stage_idx}_e{epoch}")
                    if layout.writes else None,
                    shard=layout.eval_shard())
                # best-score rule (train_func.py:317-320)
                if stage.loss == "L_bce":
                    score = metrics["overall_AP"]
                else:
                    score = metrics["activity_AP"] * metrics["overall_AP"]
                metrics["score"] = score
                if writer is not None:
                    writer.write(global_step, metrics, prefix="val/")
                seconds["eval_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                ckpt.save(global_step, state, metrics, write=layout.writes)
                seconds["checkpoint_s"] = time.perf_counter() - t0
            if writer is not None:
                writer.write(global_step, seconds, prefix="time/")
            print(f"stage {stage_idx} epoch {epoch} done "
                  f"({timer.epochtime():.1f}s)", flush=True)

        if on_stage_end is not None:
            on_stage_end(stage_idx, state)

    if writer is not None:
        writer.close()
    ckpt.close()
    train_pipe.close()
    val_pipe.close()
    return metrics


def run_eval(cfg: Config, workdir: str,
             val_ds: Optional[JRDBActDataset] = None,
             device="cuda", use_mesh: bool = True) -> Dict[str, float]:
    """Evaluate the latest checkpoint of ``workdir`` over the validation
    split (or ``val_ds``); writes the result files to
    ``<workdir>/results/eval`` and returns the metrics. Under a mesh (as
    ``run_training``) each process evaluates its shard and the frames are
    merged before scoring."""
    device = resolve_device(device)
    layout = _Layout(cfg, use_mesh)
    layout.mesh(device)          # checks the layout; sets this process's card
    val_ds = val_ds or JRDBActDataset(
        cfg.data, "test", training=False,
        rulebook_caps=cfg.model.lidar.max_voxels_per_stage)
    pipe = _val_pipeline(cfg, val_ds, layout)   # forks before CUDA
    model = _build_model(cfg, device)
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    ckpt.restore(TrainState(model=model, optimizer=None))
    metrics = evaluate_epoch(
        make_eval_step(model), _on_device(pipe.epoch(0), device),
        result_dir=os.path.join(workdir, "results", "eval")
        if layout.writes else None, shard=layout.eval_shard())
    ckpt.close()
    pipe.close()
    return metrics
