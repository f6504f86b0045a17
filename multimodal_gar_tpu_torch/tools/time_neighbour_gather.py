"""Time the grid pool's gather backward on the card, at the shapes of the
mil3 training micro-step.

    python3 -m multimodal_gar_tpu_torch.tools.time_neighbour_gather \\
        [--actors 10,20,35,47,60] [--seed 0] [--out FILE]

For each actor count, makes a synthetic b1 batch at mil3's full width and
16k training cap (``utils/testing.py``: 100 actor slots, the valid people
on occupied voxels, the rest padded boxes), runs MGAR's LiDAR branch
forward in training mode on the card, and takes each grid-pool scale's
gather as the layer calls it: (M, C, rows, keep), B = 1, R = 21,600, S =
16. Weights do not matter here: the rows follow from the geometry alone.
For each batch and scale, with a seeded dOut, it times between CUDA
events, each over a run of calls after a warm-up:

- ``backward_ms``: the backward the port runs (inverse map and kernel),
  a run of calls between one pair of events; ``backward_graph_ms`` the
  same calls replayed from a CUDA graph, the device's time where the
  host's work per call outlasts it;
- ``kernel_graph_ms``: the kernel's launch alone (and the zeroing of its
  tickets), on a map made beforehand, replayed from a CUDA graph;
- ``plain_ms``: the plain version, ``index_put_`` with accumulation over
  every entry, masked ones zeroed, which is the backward advanced indexing
  had;
- ``kept_plain_ms``: ``index_put_`` with accumulation over the kept entries
  alone, picked by a boolean mask (one host synchronisation a call): the
  plainest backward that skips the masked entries;
- ``index_add_ms``: ``index_add_`` over every entry, masked ones zeroed, the
  one PyTorch call that computes the same sum (float atomics, so not
  deterministic);

the last two timed only, never called by the port. It checks the kernel
against the plain version (largest difference over the largest value) and
for equal bits on two calls, and reads ``stats()`` for the kept share and
the longest row. ``bound_ms`` is the kernel's least bytes (kept rows read,
dF written, the map's perm and offsets read) over 3.35 TB/s. One JSON line
per batch and scale, and a summary line per scale.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..models import roi_grid_pool
from ..ops.kernels import neighbour_gather as ng
from ..utils.testing import cuda_graph_ms_per_launch, cuda_ms_per_launch

HBM_BYTES_PER_S = 3.35e12


def capture(model, batch_args) -> list:
    """[(M, C, rows, keep)] of each grid-pool gather in one forward of
    ``model`` (a LiDARBackbone) on ``batch_args``, in the order the scales
    run."""
    taken = []
    gather = roi_grid_pool.neighbour_gather

    def record(f, rows, keep):
        taken.append((f.shape[1], f.shape[2], rows, keep))
        return gather(f, rows, keep)
    roi_grid_pool.neighbour_gather = record
    try:
        with torch.no_grad():
            model(*batch_args)
    finally:
        roi_grid_pool.neighbour_gather = gather
    return taken


def time_scale(m: int, c: int, rows: torch.Tensor, keep: torch.Tensor,
               seed: int) -> dict:
    """The readings above for one scale's gather."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dout = torch.randn(rows.shape + (c,), device="cuda", generator=gen)
    rows32 = rows.to(torch.int32)
    b = rows.shape[0]
    ng.reset_stats("cuda")
    got = ng.neighbour_gather_backward(dout, rows32, keep, m)
    stats = ng.stats("cuda")
    again = ng.neighbour_gather_backward(dout, rows32, keep, m)
    ref = ng.neighbour_gather_backward_plain(dout, rows32, keep, m)
    err = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                               1e-30)

    skey, perm, off = ng.inverse_map(rows32, keep, m)
    windows = -(-perm.numel() // ng.LIBRARY.load().chunk)
    df = dout.new_empty((b, m, c))
    scratch = dout.new_empty((2, windows, c))
    count = torch.zeros(windows, dtype=torch.int32, device="cuda")
    buf = torch.zeros(3, dtype=torch.int64, device="cuda")

    def kernel():
        count.zero_()
        ng.launch_kernel(dout, skey, perm, off, df, scratch, count, buf)

    def backward():
        ng.neighbour_gather_backward(dout, rows32, keep, m)

    def plain():
        ng.neighbour_gather_backward_plain(dout, rows32, keep, m)

    flat = (rows + torch.arange(b, device="cuda")[:, None, None] * m
            ).reshape(-1)
    masked = torch.where(keep[:, :, None, None], dout, 0.0).reshape(-1, c)
    kept_entries = keep[:, :, None].expand(rows.shape).reshape(-1)

    def kept_plain():
        torch.zeros((b * m, c), device="cuda").index_put_(
            (flat[kept_entries],), dout.reshape(-1, c)[kept_entries],
            accumulate=True)

    def index_add():
        torch.zeros((b * m, c), device="cuda").index_add_(0, flat, masked)

    slow = dict(launches=3, repeats=3, warmup=1)
    kept = stats["kept"]
    nbytes = kept * c * 4 + b * m * c * 4 + kept * 8 + (b * m + 1) * 4
    return {
        "M": m, "C": c, "entries": stats["entries"], "kept": kept,
        "kept_share": kept / max(stats["entries"], 1),
        "longest": stats["longest"],
        "backward_ms": cuda_ms_per_launch(backward),
        "backward_graph_ms": cuda_graph_ms_per_launch(backward),
        "kernel_graph_ms": cuda_graph_ms_per_launch(kernel),
        "plain_ms": cuda_ms_per_launch(plain, **slow),
        "kept_plain_ms": cuda_ms_per_launch(kept_plain, **slow),
        "index_add_ms": cuda_ms_per_launch(index_add, **slow),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
        "rel_err": err, "equal_bits_twice": bool(torch.equal(got, again)),
    }


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    except OSError:
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--actors", default="10,20,35,47,60",
                    help="valid people of each batch, of 100 slots")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_neighbour_gather times the card: no CUDA "
                         "device")
    from ..models.lidar_backbone import LiDARBackbone
    from ..utils.testing import (batch_from_numpy, flagship_config,
                                 people_on_voxels, synthetic_batch_numpy)
    cfg = flagship_config(max_voxels=16000)
    dev = torch.device("cuda")
    model = LiDARBackbone(cfg.model.lidar, cfg.data.point_cloud, device=dev,
                          generator=torch.Generator().manual_seed(0))
    model.train()
    scales = [lc.source for lc in cfg.model.lidar.pool_layers]
    card = _card()
    lines, by_scale = [], {}
    for i, actors in enumerate(int(a) for a in args.actors.split(",")):
        fields = people_on_voxels(synthetic_batch_numpy(
            cfg, batch_size=1, seed=args.seed + i, n_valid=actors), cfg)
        batch = batch_from_numpy(fields, dev)
        batch_args = (batch.voxels, batch.voxel_coords,
                      batch.voxel_num_points, batch.voxel_valid,
                      batch.boxes3d, batch.person_valid, batch.rulebook)
        for name, (m, c, rows, keep) in zip(scales,
                                            capture(model, batch_args)):
            rec = {"actors": actors, "scale": name,
                   **time_scale(m, c, rows, keep, args.seed + i),
                   "card": card}
            lines.append(rec)
            by_scale.setdefault(name, []).append(rec)
            print(json.dumps(rec), flush=True)
    for name, recs in by_scale.items():
        summary = {"scale": name, "batches": len(recs), "card": card}
        for k in ("backward_ms", "backward_graph_ms", "kernel_graph_ms",
                  "plain_ms", "kept_plain_ms", "index_add_ms", "bound_ms",
                  "kept_share", "longest", "rel_err"):
            vals = [r[k] for r in recs]
            summary[k] = [min(vals), float(np.median(vals)), max(vals)]
        summary["equal_bits_twice"] = all(r["equal_bits_twice"]
                                          for r in recs)
        lines.append(summary)
        print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    ok = all(r.get("equal_bits_twice") and r["rel_err"] <= 1e-5
             for r in lines if "actors" in r)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
