"""The parallel layer across the cards of one host.

    torchrun --nproc-per-node=4 -m multimodal_gar_tpu_torch.tools.parallel_check

Every process joins the group that torchrun describes (NCCL on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and, for each mesh shape
of ``--meshes`` (default: N x 1 and N/2 x 2), trains MGAR at full width
(``flagship_config`` at the 16k training cap, accumulation 1, dropout
off, frames of 80-pixel squares: utils/parallel_testing.py ``mgar_steps``)
for ``--steps`` micro-steps on its block of a global batch of one sample
per data rank. Process 0 then runs the same micro-steps alone on the whole
batch, and once more on it in the reverse order, and holds each mesh run
to the first: losses to 1e-4; gradients (Adam's first moments) and the
updated parameters to 1e-4 of each leaf's largest, or within 10 times
what the single process itself moves between the two orders (float32 sums
in another order), which is printed leaf by leaf. It prints per mesh shape
the micro-steps' ms by CUDA events (the slowest rank) beside the single
process's, and the collectives' bytes per micro-step; the last line is a
JSON object of those numbers. ``--tiny`` runs utils/testing.py's
tiny_config instead (a rehearsal on the CPU). ``--people 100,61,...``
keeps sample b's first people only (uneven ranks); ``--first-moments``
also holds the first micro-step's gradients (Adam's first moments after
it) to the single process's, as chip_smoke.py 14b does. ``--float64``
(with ``--device cpu``: the CUDA kernels take float32 and bfloat16 only)
runs the mesh and the single process in float64 (utils/parallel_testing.py
``mgar_steps(float64=True)``): where the two agree to float64 rounding, a
float32 gap between them is summation order.

Each rank waits at most ``--wait-limit`` seconds without progress
(utils/parallel_testing.py: wait_limit): a stuck rank prints its rank, the
mesh shape and micro-step and the last collective it issued, and the run
ends with exit code 3; the process group's own timeout is the same. Once
the mesh runs are gathered the other ranks leave, and process 0 runs the
single-process references alone, printing a line as each starts.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import statistics
import sys

import torch
import torch.distributed as dist

TOL = 1e-4
SPREAD_FACTOR = 10.0
LR = 1e-6


def _meshes(text: str, world: int):
    if text:
        return [tuple(int(v) for v in m.split("x")) for m in text.split(",")]
    out = [(world, 1)]
    if world % 2 == 0 and world > 2:
        out.append((world // 2, 2))
    return out


def main(argv=None) -> int:
    from ..config import MeshConfig
    from ..parallel.mesh import make_mesh
    from ..utils.parallel_testing import (check_leaves, leaf_errors,
                                          mgar_steps, note_progress,
                                          spread_floor, wait_limit)
    from ..utils.testing import flagship_config, tiny_config
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--meshes", default="",
                        help="data x fsdp shapes, e.g. 4x1,2x2")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--people", default="",
                        help="people kept per sample, e.g. 100,61,80,45")
    parser.add_argument("--first-moments", action="store_true",
                        help="also compare the first micro-step's gradients")
    parser.add_argument("--wait-limit", type=float, default=300.0,
                        help="seconds a rank may wait without progress")
    parser.add_argument("--float64", action="store_true",
                        help="everything in float64 (with --device cpu)")
    args = parser.parse_args(argv)
    timeout = datetime.timedelta(seconds=args.wait_limit)
    if args.float64 and torch.device(args.device).type != "cpu":
        parser.error("--float64 runs with --device cpu")
    if torch.device(args.device).type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", timeout=timeout)
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo", timeout=timeout)
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = tiny_config() if args.tiny else flagship_config(max_voxels=16000)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=1))
    people = cfg.data.num_boxes
    uneven = [int(v) for v in args.people.split(",")] if args.people else None
    report, runs = {}, {}
    try:
        for data, fsdp in _meshes(args.meshes, world):
            with wait_limit(args.wait_limit, rank):
                note_progress(f"mesh {data}x{fsdp}")
                mesh = make_mesh(MeshConfig(data=data, fsdp=fsdp), device)
                kw = dict(cfg=cfg, lr=LR, steps=args.steps, dropout=False,
                          synthetic=dict(batch_size=data, seed=0,
                                         n_valid=people),
                          people=uneven[:data] if uneven else None,
                          first_moments=args.first_moments,
                          frame_blocks=None if args.tiny else 80,
                          float64=args.float64)
                got = mgar_steps(mesh, device, **kw)
                note_progress(f"mesh {data}x{fsdp}: gathering the ms")
                ms = [None] * world
                dist.all_gather_object(ms, got["ms"])
            print(f"rank {rank}: mesh {data}x{fsdp} done", flush=True)
            if rank == 0:
                name = f"{data}x{fsdp}"
                runs[name] = (kw, got)
                sent = {}
                for c in got["collectives"]:
                    sent[c["op"]] = sent.get(c["op"], 0) + c["bytes"]
                slowest = [max(r[i] for r in ms) for i in range(args.steps)]
                report[name] = {"ms": slowest, "bytes": sent,
                                "param_bytes": got["param_bytes"]}
            del got
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if rank == 0:
            for name, (kw, got) in runs.items():
                print(f"{name}: one process on the whole batch, both orders",
                      flush=True)
                ref = mgar_steps(None, device, **kw)
                other = mgar_steps(None, device, reverse=True, **kw)
                names = ref["names"]
                mu = [dict(zip(names, r["optimizer"]["exp_avg"]))
                      for r in (got, ref, other)]
                if args.first_moments:
                    first = [dict(zip(names, r["first_exp_avg"]))
                             for r in (got, ref, other)]
                    errs = leaf_errors(first[0], first[1], spread_floor(
                        first[1], first[2], SPREAD_FACTOR))
                    worst_first, _, _ = check_leaves(
                        errs, TOL, f"{name} first micro-step's gradients",
                        noise=True)
                    report[name]["worst_rel_first_grad"] = worst_first
                    # every leaf above 1e-9 (float64 rounding of a zero
                    # is far below), the noise leaves too: the largest
                    # error over the leaf's own largest value
                    leaf, (err, scale, _) = max(
                        errs.items(), key=lambda kv: kv[1][0] / kv[1][1]
                        if kv[1][1] > 1e-9 else 0.0)
                    report[name]["worst_leaf_first_grad"] = [leaf, err,
                                                             scale]
                for a, b in zip(got["metrics"], ref["metrics"]):
                    if abs(a["loss"] - b["loss"]) > TOL * abs(b["loss"]):
                        raise RuntimeError(f"{name}: loss {a['loss']} "
                                           f"against {b['loss']}")
                worst_mu, over_mu, noise = check_leaves(
                    leaf_errors(mu[0], mu[1], spread_floor(
                        mu[1], mu[2], SPREAD_FACTOR)),
                    TOL, f"{name} gradients", noise=True)
                worst_p, over_p, _ = check_leaves(
                    leaf_errors(got["model"], ref["model"], spread_floor(
                        ref["model"], other["model"], SPREAD_FACTOR,
                        2 * LR * args.steps)), TOL, f"{name} parameters")
                report[name].update(
                    ref_ms=ref["ms"], worst_rel_grad=worst_mu,
                    worst_rel_param=worst_p, noise_leaves=noise,
                    grads_within_spread=[(k, e, q) for k, e, q in over_mu],
                    params_within_floor=len(over_p))
                r = report[name]
                card = torch.cuda.get_device_name(device) \
                    if device.type == "cuda" else "cpu"
                warm = (statistics.median(r["ms"][1:] or r["ms"]),
                        statistics.median(ref["ms"][1:] or ref["ms"]))
                floored = [(k, f"{e:.2e}", f"{q:.0%}") for k, e, q in over_mu]
                print(f"{name} over {dist.get_backend()}, {world} processes"
                      f" on {card}: micro-step ms (slowest rank) {r['ms']},"
                      f" one process on the whole batch {ref['ms']} (median"
                      f" after the first {warm[0]:.2f} against "
                      f"{warm[1]:.2f}); collectives per micro-step "
                      f"{r['bytes']} B ({r['param_bytes']} B of "
                      f"parameters); gradients worst leaf rel err "
                      f"{worst_mu:.3e} over {len(mu[1]) - noise} leaves "
                      f"({noise} under 1e-3 of the median leaf held as "
                      f"noise), past {TOL} within {SPREAD_FACTOR} x one "
                      f"process's spread over the reversed batch: "
                      f"{floored}; parameters {worst_p:.3e}", flush=True)
                del ref, other
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            print(json.dumps({"world": world, "meshes": report}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
