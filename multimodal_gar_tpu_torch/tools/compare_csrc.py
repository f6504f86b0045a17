"""Time two versions of the CUDA sources against each other on one card.

    python3 -m multimodal_gar_tpu_torch.tools.compare_csrc --other DIR

``DIR`` holds another version of ``csrc/`` (an earlier commit's, say: ``git
archive <commit> multimodal_gar_tpu_torch/csrc | tar -x -C DIR``). For the
stem conv at one mil3 clip, and for the x-window conv and the index-map conv
over the 11 layers of VoxelBackbone8x at the 40k cap (on the uniformly
scattered synthetic rulebook and on the clustered one), the tool builds
both versions, holds this version's output to the other's (1e-4 of the
largest value) and times them in turns (other, this, this, other) within the
one process, since two runs may land on two cards. One JSON line per
kernel: ms per launch of each turn, many launches between one pair of CUDA
events. Both versions must export the same C interface.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..models.i3d import s2d_prep
from ..ops.kernels import stem_conv as stem_mod
from ..ops.kernels import subm_conv as subm_mod
from ..ops.kernels import window_conv as window_mod
from ..ops.kernels._build import KernelLibrary, load_all
from ..ops.sparse_maps import backbone_maps
from ..utils.testing import (BACKBONE_LAYERS, clustered_rulebook_numpy,
                             cuda_ms_per_launch, flagship_config,
                             synthetic_batch_numpy)

TOL = 1e-4


def _turns(mod, other: KernelLibrary, fn) -> dict:
    """``fn`` under the other library, this one, this one, the other."""
    this = mod.LIBRARY
    outs, times = {}, {"other": [], "this": []}
    try:
        for name, lib in (("other", other), ("this", this), ("this", this),
                          ("other", other)):
            mod.LIBRARY = lib
            outs[name] = fn()
            torch.cuda.synchronize()
            times[name].append(cuda_ms_per_launch(fn))
    finally:
        mod.LIBRARY = this
    outs = outs if isinstance(outs["this"], list) else \
        {k: [v] for k, v in outs.items()}
    rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for a, b in zip(outs["this"], outs["other"]))
    if rel > TOL:
        raise RuntimeError(f"{mod.__name__}: this version differs from the "
                           f"other by {rel}")
    return {"other_ms": times["other"], "this_ms": times["this"],
            "rel_err": rel}


def _sparse_layers(rulebook: dict, caps, gen):
    """(map, explicit map, table, weights) per VoxelBackbone8x layer."""
    rb = {k: torch.from_numpy(v).cuda() for k, v in rulebook.items()}
    maps = backbone_maps(rb, key_sorted=False, with_bwd=False)
    for name, key, stage, table_stage, c, d in BACKBONE_LAYERS:
        explicit = f"down_{stage}" if key.startswith("dwin") \
            else f"nbr_{stage}"
        table = torch.randn((1, caps[table_stage], c), device="cuda",
                            generator=gen)
        w = torch.randn((27, c, d), device="cuda", generator=gen) \
            / (27 * c) ** .5
        yield rb[key], maps[explicit].fwd, table, w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other version of csrc/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_csrc: no CUDA device", file=sys.stderr)
        return 1
    other_dir = os.path.abspath(args.other)
    mods = (stem_mod, window_mod, subm_mod)
    others = [KernelLibrary(m.LIBRARY.name, m.LIBRARY._bind, other_dir)
              for m in mods]
    load_all([m.LIBRARY for m in mods] + others)
    for mod in mods:
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
        x3 = torch.randn((1, 15, 720, 1280, 3), device="cuda", generator=gen)
        w7 = torch.randn((7, 7, 7, 3, 64), device="cuda", generator=gen) * .05
        xd, w2 = (t.contiguous() for t in s2d_prep(x3, w7))
        scale = torch.rand(64, device="cuda", generator=gen) + 0.5
        bias = torch.randn(64, device="cuda", generator=gen) * 0.1
        res = _turns(stem_mod, others[0], lambda: stem_mod.stem_conv(
            xd, w2, scale, bias, w2_is_s2d=True))
        print(json.dumps({"kernel": "stem_conv", "shape": list(xd.shape),
                          **res}))
        del x3, xd

        cfg = flagship_config()
        caps = cfg.model.lidar.max_voxels_per_stage
        books = {
            "synthetic": synthetic_batch_numpy(cfg, 1, 0, 100)["rulebook"],
            "clustered": clustered_rulebook_numpy(cfg)["rulebook"]}
        for book, rulebook in books.items():
            layers = list(_sparse_layers(rulebook, caps, gen))
            res = _turns(window_mod, others[1], lambda: [
                window_mod.window_conv(t, win, w)
                for win, _, t, w in layers])
            print(json.dumps({"kernel": "window_conv", "rulebook": book,
                              "layers": len(layers), **res}))
            res = _turns(subm_mod, others[2], lambda: [
                subm_mod.subm_conv(t, idx, w) for _, idx, t, w in layers])
            print(json.dumps({"kernel": "subm_conv", "rulebook": book,
                              "layers": len(layers), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
