"""Time two versions of the CUDA sources against each other on one card.

    python3 -m multimodal_gar_tpu_torch.tools.compare_csrc --other DIR

``DIR`` holds another version of ``csrc/`` (an earlier commit's, say: ``git
archive <commit> multimodal_gar_tpu_torch/csrc | tar -x -C DIR``). The tool
builds both versions of all five libraries, holds this version's output to
the other's (1e-4 of the largest value) and times them in turns (other,
this, this, other) within the one process, since two runs may land on two
cards:

- the stem conv at one mil3 clip;
- the x-window conv and the index-map conv over the 11 layers of
  VoxelBackbone8x at the 40k cap, on the uniformly scattered synthetic
  rulebook and on the clustered one;
- the sparse weight gradient over the same 11 layers at the 16k training
  cap, on both kinds of rulebook, tables and gradients drawn from the seeded
  generator; this version's result twice, bit for bit;
- the row gather at the shapes of the gather-probe tool's probe A and of its
  four probe E tables.

One JSON line per kernel: ms per launch of each turn, many launches between
one pair of CUDA events. For the weight gradient and the row gather, whose
launches are shorter than a call's host work, ``*_graph_ms`` is the same
run of launches captured in a CUDA graph and replayed: the device's time,
where the other reading is the host's pace. Both versions must export the
same C interface.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..models.i3d import s2d_prep
from ..ops.kernels import row_gather as gather_mod
from ..ops.kernels import sparse_wgrad as wgrad_mod
from ..ops.kernels import stem_conv as stem_mod
from ..ops.kernels import subm_conv as subm_mod
from ..ops.kernels import window_conv as window_mod
from ..ops.kernels._build import KernelLibrary, load_all
from ..ops.sparse_maps import backbone_maps
from ..utils.testing import (BACKBONE_LAYERS, clustered_rulebook_numpy,
                             cuda_graph_ms_per_launch, cuda_ms_per_launch,
                             flagship_config, synthetic_batch_numpy)
from . import probe_gather

TOL = 1e-4
MODULES = (stem_mod, window_mod, subm_mod, wgrad_mod, gather_mod)


def _turns(mod, other: KernelLibrary, fn, graph: bool = False) -> dict:
    """``fn`` under the other library, this one, this one, the other; with
    ``graph`` also as a replayed CUDA graph, and this version twice for
    equal bits."""
    this = mod.LIBRARY
    outs, times = {}, {"other": [], "this": []}
    replays = {"other": [], "this": []}

    def as_list(out):
        return out if isinstance(out, list) else [out]

    try:
        for name, lib in (("other", other), ("this", this), ("this", this),
                          ("other", other)):
            mod.LIBRARY = lib
            outs[name] = as_list(fn())
            torch.cuda.synchronize()
            times[name].append(cuda_ms_per_launch(fn))
            if graph:
                replays[name].append(cuda_graph_ms_per_launch(fn))
            if name == "this":
                again = as_list(fn())
    finally:
        mod.LIBRARY = this
    rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for a, b in zip(outs["this"], outs["other"]))
    if rel > TOL:
        raise RuntimeError(f"{mod.__name__}: this version differs from the "
                           f"other by {rel}")
    if not all(torch.equal(a, b) for a, b in zip(again, outs["this"])):
        raise RuntimeError(f"{mod.__name__}: two runs of this version differ")
    res = {"other_ms": times["other"], "this_ms": times["this"],
           "rel_err": rel}
    if graph:
        res.update(other_graph_ms=replays["other"],
                   this_graph_ms=replays["this"], twice_equal=True)
    return res


def _sparse_layers(rulebook: dict, caps, gen, key_sorted: bool = False):
    """(map, explicit map, table, weights, output gradient) per
    VoxelBackbone8x layer."""
    rb = {k: torch.from_numpy(v).cuda() for k, v in rulebook.items()}
    maps = backbone_maps(rb, key_sorted=key_sorted, with_bwd=False)
    for name, key, stage, table_stage, c, d in BACKBONE_LAYERS:
        explicit = f"down_{stage}" if key.startswith("dwin") \
            else f"nbr_{stage}"
        idx = maps[explicit].fwd
        table = torch.randn((1, caps[table_stage], c), device="cuda",
                            generator=gen)
        w = torch.randn((27, c, d), device="cuda", generator=gen) \
            / (27 * c) ** .5
        dout = torch.randn((1, idx.shape[1], d), device="cuda", generator=gen)
        yield rb[key], idx, table, w, dout


def compare_stem(other: KernelLibrary, gen) -> None:
    x3 = torch.randn((1, 15, 720, 1280, 3), device="cuda", generator=gen)
    w7 = torch.randn((7, 7, 7, 3, 64), device="cuda", generator=gen) * .05
    xd, w2 = (t.contiguous() for t in s2d_prep(x3, w7))
    scale = torch.rand(64, device="cuda", generator=gen) + 0.5
    bias = torch.randn(64, device="cuda", generator=gen) * 0.1
    res = _turns(stem_mod, other, lambda: stem_mod.stem_conv(
        xd, w2, scale, bias, w2_is_s2d=True))
    print(json.dumps({"kernel": "stem_conv", "shape": list(xd.shape), **res}))


def compare_forward(other_window: KernelLibrary, other_subm: KernelLibrary,
                    gen) -> None:
    """window_conv and subm_conv over the 11 layers at the 40k cap."""
    cfg = flagship_config()
    caps = cfg.model.lidar.max_voxels_per_stage
    books = {"synthetic": synthetic_batch_numpy(cfg, 1, 0, 100)["rulebook"],
             "clustered": clustered_rulebook_numpy(cfg)["rulebook"]}
    for book, rulebook in books.items():
        layers = list(_sparse_layers(rulebook, caps, gen))
        res = _turns(window_mod, other_window, lambda: [
            window_mod.window_conv(t, win, w) for win, _, t, w, _ in layers])
        print(json.dumps({"kernel": "window_conv", "rulebook": book,
                          "layers": len(layers), **res}))
        res = _turns(subm_mod, other_subm, lambda: [
            subm_mod.subm_conv(t, idx, w) for _, idx, t, w, _ in layers])
        print(json.dumps({"kernel": "subm_conv", "rulebook": book,
                          "layers": len(layers), **res}))


def compare_wgrad(other: KernelLibrary, gen) -> None:
    """sparse_wgrad over the 11 layers at the 16k training cap."""
    cfg = flagship_config(max_voxels=16000)
    caps = cfg.model.lidar.max_voxels_per_stage
    books = {"synthetic": synthetic_batch_numpy(cfg, 1, 0, 100)["rulebook"],
             "clustered": clustered_rulebook_numpy(cfg)["rulebook"]}
    for book, rulebook in books.items():
        layers = list(_sparse_layers(rulebook, caps, gen, key_sorted=True))
        res = _turns(wgrad_mod, other, lambda: [
            wgrad_mod.sparse_wgrad(t, idx, dout)
            for _, idx, t, _, dout in layers], graph=True)
        taps = sum(int((idx >= 0).sum()) for _, idx, _, _, _ in layers)
        print(json.dumps({"kernel": "sparse_wgrad", "rulebook": book,
                          "layers": len(layers), "taps": taps, **res}))


def compare_row_gather(other: KernelLibrary) -> None:
    """row_gather at probe A's shape and at probe E's four."""
    rng = np.random.default_rng(0)
    shapes = [(probe_gather.M, probe_gather.C, probe_gather.K3)] \
        + [(m, width, 1) for m, width in probe_gather.e_shapes()]
    for m, c, k in shapes:
        tab = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32)
                               ).cuda()
        idx = torch.from_numpy(rng.integers(0, m, (m, k)).astype(np.int32)
                               ).cuda()
        res = _turns(gather_mod, other,
                     lambda: gather_mod.row_gather(tab, idx), graph=True)
        print(json.dumps({"kernel": "row_gather", "M": m, "C": c, "K": k,
                          **res}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other version of csrc/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_csrc: no CUDA device", file=sys.stderr)
        return 1
    other_dir = os.path.abspath(args.other)
    others = {m: KernelLibrary(m.LIBRARY.name, m.LIBRARY._bind, other_dir)
              for m in MODULES}
    load_all([m.LIBRARY for m in MODULES] + list(others.values()))
    for mod in MODULES:
        lib = mod.LIBRARY
        print(f"build {lib.name}: {lib.build_seconds:.2f} s")
        for line in lib.ptxas_log.splitlines():
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"  {line.strip()}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        compare_stem(others[stem_mod], gen)
        compare_forward(others[window_mod], others[subm_mod], gen)
        compare_wgrad(others[wgrad_mod], gen)
        compare_row_gather(others[gather_mod])
    return 0


if __name__ == "__main__":
    sys.exit(main())
