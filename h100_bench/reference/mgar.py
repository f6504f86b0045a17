"""The plain reference of the MGAR cells: the frozen copy of the port's
module math (reference/frozen/), every hand-written kernel replaced by its
plain version, float32 with TF32 off (``tf32=True`` is the control).

It takes from the benchmark the configuration file, the seed (the weights
are drawn anew from it, as for the program) and the benchmark-made clip
fields: frames, boxes, labels and voxels. The program's rulebook is left
out: the reference builds its maps on the device itself (the frozen
ops/device_rulebook.py) and runs the index-map path.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from harness import load_module, load_weights_, make_config, seeded_weights

BATCH_FIELDS = ("images", "boxes2d", "boxes3d", "person_valid",
                "social_group_id", "actions", "social_group_activity",
                "voxels", "voxel_coords", "voxel_num_points", "voxel_valid",
                "seq_id", "frame_id")


def _model(cfgj: dict, loop: str, seed: int, device):
    from reference.frozen.config import Config
    from reference.frozen.models.mgar import MGAR
    cfg = make_config(Config, cfgj, loop)
    model = MGAR(cfg, device=device,
                 generator=torch.Generator().manual_seed(0))
    load_weights_(model, seeded_weights(model.state_dict(), seed, device))
    return cfg, model


def _batch(clip, device):
    """The frozen Batch of a pool clip's benchmark-made fields, no
    rulebook."""
    from reference.frozen.types import Batch
    return Batch(**{f: getattr(clip, f).to(device) for f in BATCH_FIELDS})


def eval_outputs(cfgj: dict, seed: int, clips: dict, device,
                 tf32: bool = False) -> Dict[int, Dict[str, torch.Tensor]]:
    """The reference's eval outputs of each clip (pool index -> clip)."""
    compare = load_module("reference", "compare.py")
    with compare.precision(tf32):
        _, model = _model(cfgj, "eval", seed, device)
        model.eval()
        out = {}
        with torch.inference_mode():
            for idx, clip in clips.items():
                out[idx] = compare.flat_outputs(model(_batch(clip,
                                                             device)))
    del model
    return out


def train_readings(cfgj: dict, wl: dict, seed: int, dropout_seed: int,
                   pool: List, device, tf32: bool = False) -> dict:
    """The reference's readings of the first ``checked_updates`` updates:
    each micro-step's loss, each trainable leaf's first gradient norm as
    Adam got it, and each leaf's change over the updates."""
    from reference.frozen.train.train_state import (make_optimizer,
                                                    make_train_step)
    compare = load_module("reference", "compare.py")
    with compare.precision(tf32):
        cfg, model = _model(cfgj, "train", seed, device)
        tr = cfg.train
        accum = tr.grad_accum_steps
        opt = make_optimizer(model.parameters(), tr.stages[0],
                             steps_per_epoch=wl["steps_per_epoch"],
                             grad_accum=accum, gamma=tr.lr_decay_gamma)
        step = make_train_step(model, opt, tr.stages[0].loss,
                               seed=dropout_seed)
        out = compare.train_readings(
            model, opt.params, opt.adam,
            lambda i: step(_batch(pool[i], device)),
            wl["checked_updates"] * accum, accum, len(pool))
    del model, opt, step
    return out
