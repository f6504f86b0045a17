"""Time two versions of the CUDA sources against each other on one card.

    python3 -m multimodal_gar_tpu_torch.tools.compare_csrc --other DIR

``DIR`` holds another version of ``csrc/`` (an earlier commit's, say: ``git
archive <commit> multimodal_gar_tpu_torch/csrc | tar -x -C DIR``). The tool
builds both versions of all five libraries and times them in turns (other,
this, this, other) within the one process, since two runs may land on two
cards, checking this version's output twice for equal bits:

- the stem conv at one mil3 clip, float32 and bf16;
- the x-window conv and the index-map conv over the 11 layers of
  VoxelBackbone8x at the 40k cap, on the uniformly scattered synthetic
  rulebook and on the clustered one, float32 and bf16;
- the sparse weight gradient over the same 11 layers at the 16k training
  cap, on both kinds of rulebook, tables and gradients drawn from the seeded
  generator;
- kernels C and D (the bf16 data and weight gradients) over the 16k
  layers of both rulebooks;
- the row gather at the shapes of the gather-probe tool's probe A and of its
  four probe E tables.

Kernels C and D are the kernels under comparison: kernel C's float32 output
is held to the other version's within one bf16 ulp of the largest tap
product entering each element (utils/testing.py: dgrad_bf16_check), since
its taps are added in another float32 association, and kernel D's bf16 dW
within one bf16 ulp (bf16_ulp_check), since its float32 sum runs in
another order. Every other kernel is a control, whose code the comparison
does not change: its outputs are held to the other version's bit for bit
(main exits 1 where they differ). One JSON line per kernel: ms per launch
of each turn, many launches between one pair of CUDA events. For the
sparse kernels, whose launches are shorter than a call's host work,
``*_graph_ms`` is the same run of launches captured in a CUDA graph and
replayed: the device's time, where the other reading is the host's pace.
Both versions export the same C interface, except where a version number
says otherwise, and the tool calls each version by its own: the bf16
stem's (``mgar_stem_conv_bf16_abi``: 2 since it takes xd in rows of an
even width) and kernel D's (``mgar_sparse_wgrad_bf16_abi``: 2 since it
takes the maps' tap columns and no scratch).
"""
from __future__ import annotations

import argparse
import ctypes
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
from ..ops.kernels._build import KernelLibrary, load_all, stream_handle
from ..ops.sparse_maps import backbone_maps
from ..utils.testing import (BACKBONE_LAYERS, bf16_ulp_check,
                             clustered_rulebook_numpy,
                             cuda_graph_ms_per_launch, cuda_ms_per_launch,
                             dgrad_bf16_check, dgrad_tap_max,
                             flagship_config, synthetic_batch_numpy)
from . import probe_gather

MODULES = (stem_mod, window_mod, subm_mod, wgrad_mod, gather_mod)


def _turns(mod, other: KernelLibrary, fn, graph: bool = False,
           other_fn=None, compare=None) -> dict:
    """``fn`` under the other library, this one, this one, the other; with
    ``graph`` also as a replayed CUDA graph; this version twice for equal
    bits. ``other_fn`` is the other version's call where it differs from
    this one's; ``compare(this outputs, other outputs)`` returns the
    comparison's keys (default: the largest difference relative to the
    other's largest value, and whether the bits are equal)."""
    this = mod.LIBRARY
    outs, times = {}, {"other": [], "this": []}
    replays = {"other": [], "this": []}
    calls = {"other": other_fn or fn, "this": fn}

    def as_list(out):
        return out if isinstance(out, list) else [out]

    try:
        for name, lib in (("other", other), ("this", this), ("this", this),
                          ("other", other)):
            mod.LIBRARY = lib
            call = calls[name]
            outs[name] = as_list(call())
            torch.cuda.synchronize()
            times[name].append(cuda_ms_per_launch(call))
            if graph:
                replays[name].append(cuda_graph_ms_per_launch(call))
            if name == "this":
                again = as_list(call())
    finally:
        mod.LIBRARY = this
    if not all(torch.equal(a, b) for a, b in zip(again, outs["this"])):
        raise RuntimeError(f"{mod.__name__}: two runs of this version differ")
    res = {"other_ms": times["other"], "this_ms": times["this"],
           **(compare or _relative)(outs["this"], outs["other"]),
           "twice_equal": True}
    if graph:
        res.update(other_graph_ms=replays["other"],
                   this_graph_ms=replays["this"])
    return res


# the controls whose bits differed from the other version's; main exits 1
# if there are any
UNEQUAL: list = []


def _relative(this: list, other: list) -> dict:
    """The comparison of code that should give the other version's bits:
    the largest difference over the other's largest value, and whether the
    bits are equal (recorded in UNEQUAL where they are not)."""
    rel = max((a.float() - b.float()).abs().max().item()
              / max(b.float().abs().max().item(), 1e-30)
              for a, b in zip(this, other))
    equal = all(torch.equal(a, b) for a, b in zip(this, other))
    if not equal:
        UNEQUAL.append(rel)
    return {"rel_err": rel, "bits_equal": equal}


def _ulps(this: list, other: list) -> dict:
    """Kernel D's comparison: every element of each bf16 output within one
    bf16 ulp of the other version's."""
    checks = [bf16_ulp_check(a, b) for a, b in zip(this, other)]
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise RuntimeError(f"this version is not within one bf16 ulp of "
                           f"the other: {bad[0]}")
    return {"max_ulps": max(c["max_ulps"] for c in checks),
            "share_differing": max(c["share_differing"] for c in checks),
            "bits_equal": all(torch.equal(a, b)
                              for a, b in zip(this, other))}


def _sparse_layers(rulebook: dict, caps, gen, key_sorted: bool = False,
                   dtype=torch.float32):
    """(map, explicit map, table, weights, output gradient, ConvMaps) per
    VoxelBackbone8x layer."""
    rb = {k: torch.from_numpy(v).cuda() for k, v in rulebook.items()}
    maps = backbone_maps(rb, key_sorted=key_sorted, with_bwd=key_sorted)
    for name, key, stage, table_stage, c, d in BACKBONE_LAYERS:
        explicit = f"down_{stage}" if key.startswith("dwin") \
            else f"nbr_{stage}"
        m = maps[explicit]
        table = torch.randn((1, caps[table_stage], c), device="cuda",
                            generator=gen).to(dtype)
        w = (torch.randn((27, c, d), device="cuda", generator=gen)
             / (27 * c) ** .5).to(dtype)
        dout = torch.randn((1, m.fwd.shape[1], d), device="cuda",
                           generator=gen).to(dtype)
        yield rb[key], m.fwd, table, w, dout, m


def _rulebooks(max_voxels=None) -> dict:
    cfg = flagship_config() if max_voxels is None \
        else flagship_config(max_voxels=max_voxels)
    return cfg.model.lidar.max_voxels_per_stage, {
        "synthetic": synthetic_batch_numpy(cfg, 1, 0, 100)["rulebook"],
        "clustered": clustered_rulebook_numpy(cfg)["rulebook"]}


def compare_stem(other: KernelLibrary, gen) -> None:
    x3 = torch.randn((1, 15, 720, 1280, 3), device="cuda", generator=gen)
    w7 = torch.randn((7, 7, 7, 3, 64), device="cuda", generator=gen) * .05
    xd, w2 = (t.contiguous() for t in s2d_prep(x3, w7))
    scale = torch.rand(64, device="cuda", generator=gen) + 0.5
    bias = torch.randn(64, device="cuda", generator=gen) * 0.1
    res = _turns(stem_mod, other, lambda: stem_mod.stem_conv(
        xd, w2, scale, bias, w2_is_s2d=True))
    print(json.dumps({"kernel": "stem_conv", "shape": list(xd.shape), **res}))


def _stem_bf16_abi1(lib: KernelLibrary, xd, w2, bias):
    """A call of a bf16 stem library of the first C interface (contiguous
    xd, w2 unpacked: the mma.sync kernel)."""
    cdll = lib.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.mgar_stem_conv_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    b, t, hp, wp, _ = xd.shape
    t_out = (t + 6 - 7) // 2 + 1

    def call():
        out = torch.empty((b, 64, t_out, hp - 3, wp - 3),
                          dtype=torch.bfloat16, device=xd.device)
        err = cdll.mgar_stem_conv_bf16(
            xd.data_ptr(), w2.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            t, hp, wp, t_out, 3, stream_handle(xd.device))
        if err != 0:
            raise RuntimeError(f"the other bf16 stem failed: {err}")
        return out
    return call


def compare_stem_bf16(other: KernelLibrary, gen) -> None:
    """The bf16 stem at one mil3 clip, xd in rows of an even width as the
    model lays it out (an earlier interface gets it contiguous)."""
    bf = torch.bfloat16
    x3 = torch.randn((1, 15, 720, 1280, 3), device="cuda", generator=gen)
    w7 = torch.randn((7, 7, 7, 3, 64), device="cuda", generator=gen) * .05
    xd, w2 = s2d_prep(x3.to(bf), w7.to(bf), even_width=True)
    del x3
    w2 = w2.contiguous()
    bias = (torch.randn(64, device="cuda", generator=gen) * 0.1).to(bf)
    other_fn = None
    if not hasattr(other.load(), "mgar_stem_conv_bf16_abi"):
        other_fn = _stem_bf16_abi1(other, xd.contiguous(), w2, bias)
    res = _turns(stem_mod, other, lambda: stem_mod.stem_conv_bf16(
        xd, w2, bias, w2_is_s2d=True), other_fn=other_fn)
    print(json.dumps({"kernel": "stem_conv_bf16", "shape": list(xd.shape),
                      **res}))


def compare_forward(other_window: KernelLibrary, other_subm: KernelLibrary,
                    gen, dtype=torch.float32) -> None:
    """window_conv and subm_conv over the 11 layers at the 40k cap."""
    caps, books = _rulebooks()
    bf16 = dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    for book, rulebook in books.items():
        layers = list(_sparse_layers(rulebook, caps, gen, dtype=dtype))
        kw = dict(graph=True) if bf16 else {}
        res = _turns(window_mod, other_window, lambda: [
            window_mod.window_conv(t, win, w)
            for win, _, t, w, _, _ in layers], **kw)
        print(json.dumps({"kernel": "window_conv" + suffix, "rulebook": book,
                          "layers": len(layers), **res}))
        res = _turns(subm_mod, other_subm, lambda: [
            subm_mod.subm_conv(t, idx, w)
            for _, idx, t, w, _, _ in layers], **kw)
        print(json.dumps({"kernel": "subm_conv" + suffix, "rulebook": book,
                          "layers": len(layers), **res}))


def compare_wgrad(other: KernelLibrary, gen) -> None:
    """sparse_wgrad over the 11 layers at the 16k training cap."""
    caps, books = _rulebooks(16000)
    for book, rulebook in books.items():
        layers = list(_sparse_layers(rulebook, caps, gen, key_sorted=True))
        res = _turns(wgrad_mod, other, lambda: [
            wgrad_mod.sparse_wgrad(t, idx, dout)
            for _, idx, t, _, dout, _ in layers], graph=True)
        taps = sum(int((idx >= 0).sum()) for _, idx, _, _, _, _ in layers)
        print(json.dumps({"kernel": "sparse_wgrad", "rulebook": book,
                          "layers": len(layers), "taps": taps, **res}))


def _wgrad_bf16_abi1(lib: KernelLibrary, args: list):
    """Calls of a kernel D library of the first C interface (the (B, R, 27)
    maps and a float32 scratch of partial sums) over ``args``: (table,
    idx, dout) per layer."""
    cdll = lib.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.mgar_sparse_wgrad_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    rows = cdll.mgar_sparse_wgrad_chunk()
    calls = []
    for table, idx, dout in args:
        b, m, c = table.shape
        r, d = idx.shape[1], dout.shape[-1]
        if c < 16:                    # the wrapper's padded input layer
            table = torch.nn.functional.pad(table, (0, 16 - c))
        partial = torch.empty((-(-b * r // rows), 27, table.shape[-1], d),
                              dtype=torch.float32, device=table.device)
        calls.append((table, idx, dout, partial, c))

    def call():
        outs = []
        for table, idx, dout, partial, c in calls:
            b, m, cp = table.shape
            r, d = idx.shape[1], dout.shape[-1]
            dw = torch.empty((27, cp, d), dtype=torch.bfloat16,
                             device=table.device)
            err = cdll.mgar_sparse_wgrad_bf16(
                table.data_ptr(), idx.data_ptr(), dout.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), b, r, m, cp, d,
                stream_handle(table.device))
            if err != 0:
                raise RuntimeError(f"the other kernel D failed: {err}")
            outs.append(dw[:, :c].contiguous() if cp != c else dw)
        return outs
    return call


def _dgrad_ulps(dgrad: list):
    """Kernel C's comparison: each float32 element within one bf16 ulp of
    the largest tap product entering it."""
    tap_max = [dgrad_tap_max(*a) for a in dgrad]

    def compare(this: list, other: list) -> dict:
        checks = [dgrad_bf16_check(a, b, t)
                  for a, b, t in zip(this, other, tap_max)]
        bad = [c for c in checks if not c["ok"]]
        if bad:
            raise RuntimeError(f"kernel C is not within one bf16 ulp of the "
                               f"other version's: {bad[0]}")
        return {"share_differing": max(c["share_differing"]
                                       for c in checks),
                "max_abs_err": max(c["max_abs_err"] for c in checks),
                "bits_equal": all(torch.equal(a, b)
                                  for a, b in zip(this, other))}
    return compare


def compare_bf16_grads(other_subm: KernelLibrary, other_wgrad: KernelLibrary,
                       gen) -> None:
    """Kernels C (10 layers) and D (11 layers) at the 16k training cap, the
    kernels under comparison: each layer's cluster size, and the turns.
    Kernel D gets each map's tap columns, made once per map as the
    training step makes them (ops/sparse_maps.py: ConvMaps.fwd_taps)."""
    caps, books = _rulebooks(16000)
    for book, rulebook in books.items():
        layers = list(_sparse_layers(rulebook, caps, gen, key_sorted=True,
                                     dtype=torch.bfloat16))
        dgrad = [(dout, m.bwd, m.dgrad_weights(w))
                 for _, _, _, w, dout, m in layers[1:]]
        clusters = [subm_mod.subm_conv_dgrad_bf16_cluster(
            a[0].shape[0], a[1].shape[1], a[0].shape[-1], a[2].shape[-1])
            for a in dgrad]
        res = _turns(subm_mod, other_subm, lambda: [
            subm_mod.subm_conv_dgrad_bf16(*a) for a in dgrad], graph=True,
            compare=_dgrad_ulps(dgrad))
        print(json.dumps({"kernel": "subm_conv_dgrad_bf16", "rulebook": book,
                          "layers": len(dgrad), "clusters": clusters,
                          **res}))
        wargs = [(t, idx, dout, m.fwd_taps)
                 for _, idx, t, _, dout, m in layers]
        other_fn = None
        if not hasattr(other_wgrad.load(), "mgar_sparse_wgrad_bf16_abi"):
            other_fn = _wgrad_bf16_abi1(other_wgrad,
                                        [a[:3] for a in wargs])
        res = _turns(wgrad_mod, other_wgrad, lambda: [
            wgrad_mod.sparse_wgrad_bf16(*a) for a in wargs], graph=True,
            other_fn=other_fn, compare=_ulps)
        print(json.dumps({"kernel": "sparse_wgrad_bf16", "rulebook": book,
                          "layers": len(layers),
                          "cluster": wgrad_mod.sparse_wgrad_bf16_cluster(),
                          **res}))


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
        compare_stem_bf16(others[stem_mod], gen)
        compare_forward(others[window_mod], others[subm_mod], gen)
        compare_forward(others[window_mod], others[subm_mod], gen,
                        torch.bfloat16)
        compare_wgrad(others[wgrad_mod], gen)
        compare_bf16_grads(others[subm_mod], others[wgrad_mod], gen)
        compare_row_gather(others[gather_mod])
    if UNEQUAL:
        print(f"compare_csrc: {len(UNEQUAL)} comparisons that should be bit "
              f"for bit differ (largest relative difference "
              f"{max(UNEQUAL):.3e})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
