"""CLI: python -m multimodal_gar_tpu_torch train --config cfg.yaml --workdir out/

The same two subcommands and flags as ``python -m multimodal_gar_tpu``,
plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU, and
without a card the default raises at once).

Under ``torchrun --nproc-per-node=N -m multimodal_gar_tpu_torch train ...``
(``WORLD_SIZE`` > 1) each process joins the process group, NCCL on
``cuda:LOCAL_RANK`` or gloo with ``--device cpu``, and the run is data
parallel over ``mesh.data`` x ``mesh.fsdp`` (train/loop.py); without
``torchrun`` nothing changes.
"""
from __future__ import annotations

import argparse
import os
import sys


def _join_group(device: str) -> str:
    """Initialise the process group that torchrun's environment
    describes; returns this process's device."""
    import torch
    import torch.distributed as dist
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = f"cuda:{local}"
        torch.cuda.set_device(device)
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(prog="multimodal_gar_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="run staged training + eval")
    p_train.add_argument("--config", default=None, help="YAML config path")
    p_train.add_argument("--workdir", required=True)
    p_train.add_argument("--set", action="append", default=[],
                         help="dotted config override, e.g. train.batch_size=2")
    p_train.add_argument("--max-steps-per-epoch", type=int, default=None)
    p_train.add_argument("--device", default="cuda")

    p_eval = sub.add_parser("eval", help="evaluate a checkpoint")
    p_eval.add_argument("--config", default=None)
    p_eval.add_argument("--workdir", required=True)
    p_eval.add_argument("--set", action="append", default=[])
    p_eval.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)

    from .config import load_config
    from .train.loop import run_eval, run_training
    cfg = load_config(args.config, overrides=args.set)

    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    device = _join_group(args.device) if distributed else args.device
    try:
        if args.cmd == "train":
            metrics = run_training(
                cfg, args.workdir,
                max_steps_per_epoch=args.max_steps_per_epoch, device=device)
            print("final:", metrics)
        elif args.cmd == "eval":
            metrics = run_eval(cfg, args.workdir, device=device)
            print("eval:", metrics)
    finally:
        if distributed:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
