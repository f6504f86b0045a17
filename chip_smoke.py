#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multimodal_gar_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from multimodal_gar_tpu_torch/csrc/ into
multimodal_gar_tpu_torch/build/, then:

  1. prints the card (nvidia-smi name and power limit);
  2. builds the four kernels at once (one nvcc each) and prints the build
     seconds and ptxas usage;
  3. holds the stem and the x-window sparse conv against their plain
     PyTorch versions at the mil3 shapes (the stem at one 15 x 720 x 1280
     clip, the sparse conv at all 11 layers of VoxelBackbone8x over a
     40k-voxel flagship rulebook) and times both with CUDA events;
  3b. holds the index-map sparse conv (K3) against its plain version as the
     forward of all 11 layers over the 40k rulebook's nbr_k / down_k maps
     and as the data gradient of 10 layers over the transposed maps of a
     16k training rulebook, and the weight gradient (K4) for all 11 layers
     of that rulebook; times each with CUDA events;
  4. runs the whole MGAR eval forward at tiny_config on the card (kernels)
     and on the CPU (plain versions) with the same seeded weights, and
     compares every output;
  4b. runs one train step's forward and backward at tiny_config on the card
     and on the CPU (same weights and batch, dropout off) and compares the
     loss, every parameter gradient and the new BatchNorm statistics;
  5. serves 3 requests of the full-width slice (flagship_config: 720x1280,
     15 frames, 100 actors, 40k voxels, random seeded weights) through the
     eval step, checks the outputs and that each request launched the stem
     kernel once and the x-window sparse conv 11 times;
  5b. serves the same 3 requests on the nbr-map path (x_window off): each
     launches K3 11 times and the x-window kernel never, and the outputs
     match the x-window path's;
  6. trains at full width (flagship_config at the 16k training cap, b1,
     grad_accum_steps 8, L_total, dropout on) for 16 micro-steps: each
     launches the stem once, the x-window conv 11 times, K3 10 times and K4
     11 times; the loss stays finite, no gradient is non-finite, and the
     parameters move only at micro-steps 8 and 16.

Phases 5, 5b and 6 drive the main paths: the launch counts are set to 0
just before each and read just after. Any failure raises and the script
exits non-zero. The line before the last is a JSON object with each
kernel's numbers; the last line is {"ok": true, "device": {...}}. Without a
CUDA device it exits 1 at once.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# kernels hold the plain version to 1e-4 of the largest reference value:
# both are float32 and differ only in summation order (measured ~2e-6 for
# the stem's K = 1344 sums and ~1e-6 for the sparse conv)
KERNEL_TOL = 1e-4
# card (kernels, cuDNN) against CPU (plain versions) through the whole
# model, forward and backward: float32 everywhere, sums in other orders
# through ~20 layers
MODEL_TOL = 1e-4
# gradients that are zero in exact arithmetic (utils/testing.py:
# BN_CANCELLED_BIASES): both sides below this share of their layer's weight
# gradient, as rounding noise
NOISE_TOL = 1e-3
WARMUP, REPEATS = 3, 10
SRC = "multimodal_gar_tpu_torch/csrc"


def check(ok, message: str) -> None:
    """Fail the run (independent of python -O)."""
    if not ok:
        raise RuntimeError(message)


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = (got.double() - ref.double()).abs().max().item()
    return err, err / max(ref.double().abs().max().item(), 1e-30)


def median_ms(fn) -> float:
    """Median device time of ``fn`` in ms over REPEATS calls, CUDA events."""
    import torch
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")


def phase_build():
    from multimodal_gar_tpu_torch.ops.kernels import (sparse_wgrad, stem_conv,
                                                      subm_conv, window_conv)
    from multimodal_gar_tpu_torch.ops.kernels._build import load_all
    mods = (stem_conv, window_conv, subm_conv, sparse_wgrad)
    t0 = time.perf_counter()
    load_all([mod.LIBRARY for mod in mods])
    print(f"build, 4 libraries at once: {time.perf_counter() - t0:.2f} s")
    for mod in mods:
        lib = mod.LIBRARY
        print(f"build {lib.name}: {lib.build_seconds:.2f} s")
        for line in lib.ptxas_log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {line.strip()}")


def phase_stem(gen) -> dict:
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.stem_conv import (
        stem_conv, stem_conv_plain)
    dev = "cuda"
    xd = torch.randn((1, 15, 363, 643, 12), device=dev, generator=gen)
    w2 = torch.randn((7, 4, 4, 12, 64), device=dev, generator=gen) * 0.05
    scale = torch.rand(64, device=dev, generator=gen) + 0.5
    bias = torch.randn(64, device=dev, generator=gen) * 0.1
    got = stem_conv(xd, w2, scale, bias)
    ref = stem_conv_plain(xd, w2, scale, bias)
    torch.cuda.synchronize()
    check(got.shape == ref.shape == (1, 64, 8, 360, 640),
          f"stem_conv output {tuple(got.shape)}")
    err, rel = rel_err(got, ref)
    ms = median_ms(lambda: stem_conv(xd, w2, scale, bias))
    plain_ms = median_ms(lambda: stem_conv_plain(xd, w2, scale, bias))
    print(f"stem_conv {tuple(xd.shape)} -> {tuple(got.shape)}: max abs err "
          f"{err:.3e}, rel {rel:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f}"
          f" ms")
    check(rel <= KERNEL_TOL, f"stem_conv rel err {rel} > {KERNEL_TOL}")
    return {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms}


# VoxelBackbone8x: (layer, map, stage of the map, stage of the table, C, D)
WINDOW_LAYERS = (
    ("conv_input", "win_0", 0, 0, 4, 16),
    ("conv1_0", "win_0", 0, 0, 16, 16),
    ("conv2_down", "dwin_1", 1, 0, 16, 32),
    ("conv2_1", "win_1", 1, 1, 32, 32),
    ("conv2_2", "win_1", 1, 1, 32, 32),
    ("conv3_down", "dwin_2", 2, 1, 32, 64),
    ("conv3_1", "win_2", 2, 2, 64, 64),
    ("conv3_2", "win_2", 2, 2, 64, 64),
    ("conv4_down", "dwin_3", 3, 2, 64, 64),
    ("conv4_1", "win_3", 3, 3, 64, 64),
    ("conv4_2", "win_3", 3, 3, 64, 64),
)


def phase_window(fields, caps, gen) -> dict:
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
        window_conv, window_conv_plain)
    dev = "cuda"
    worst_err = worst_rel = 0.0
    total_ms = total_plain = 0.0
    for name, key, _, table_stage, c, d in WINDOW_LAYERS:
        win = torch.from_numpy(fields["rulebook"][key]).to(dev)
        m = caps[table_stage]
        feats = torch.randn((1, m, c), device=dev, generator=gen)
        w = torch.randn((27, c, d), device=dev, generator=gen) / (27 * c) ** .5
        got = window_conv(feats, win, w)
        ref = window_conv_plain(feats, win, w)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        ms = median_ms(lambda: window_conv(feats, win, w))
        plain_ms = median_ms(lambda: window_conv_plain(feats, win, w))
        print(f"window_conv {name}: R {win.shape[1]} M {m} C {c} D {d}: max "
              f"abs err {err:.3e}, rel {rel:.3e}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms")
        check(rel <= KERNEL_TOL, f"window_conv {name} rel err {rel}")
        worst_err, worst_rel = max(worst_err, err), max(worst_rel, rel)
        total_ms += ms
        total_plain += plain_ms
    print(f"window_conv, 11 layers: kernel {total_ms:.3f} ms, plain "
          f"{total_plain:.3f} ms")
    return {"max_abs_err": worst_err, "max_rel_err": worst_rel,
            "ms": total_ms, "plain_ms": total_plain}


def _time_pair(name, kernel, plain) -> tuple:
    """(max abs err, rel err, kernel ms, plain ms) of one kernel call."""
    import torch
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    check(rel <= KERNEL_TOL, f"{name} rel err {rel}")
    return err, rel, median_ms(kernel), median_ms(plain)


def phase_subm_wgrad(fields40, caps40, fields16, caps16, gen) -> tuple:
    """K3 as the nbr-map forward (40k rulebook, 11 layers) and as the data
    gradient (16k training rulebook, 10 layers); K4 for the 11 layers of
    the 16k rulebook."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
        sparse_wgrad, sparse_wgrad_plain)
    from multimodal_gar_tpu_torch.ops.kernels.subm_conv import (
        subm_conv, subm_conv_plain)
    from multimodal_gar_tpu_torch.ops.sparse_maps import backbone_maps
    dev = "cuda"

    def rulebook(fields):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in fields["rulebook"].items()}

    def weights(c, d):
        return torch.randn((27, c, d), device=dev, generator=gen) \
            / (27 * c) ** .5

    k3 = {"err": 0.0, "rel": 0.0, "ms": 0.0, "plain_ms": 0.0}
    k4 = dict(k3)

    def add(acc, res):
        acc["err"], acc["rel"] = max(acc["err"], res[0]), max(acc["rel"],
                                                               res[1])
        acc["ms"] += res[2]
        acc["plain_ms"] += res[3]

    maps40 = backbone_maps(rulebook(fields40), key_sorted=False,
                           with_bwd=False)
    for name, _, _, table_stage, c, d in WINDOW_LAYERS:
        key = _map_key(name)
        idx = maps40[key].fwd
        table = torch.randn((1, caps40[table_stage], c), device=dev,
                            generator=gen)
        w = weights(c, d)
        res = _time_pair(f"subm_conv forward {name}",
                         lambda: subm_conv(table, idx, w),
                         lambda: subm_conv_plain(table, idx, w))
        add(k3, res)
        print(f"subm_conv forward {name}: R {idx.shape[1]} M {table.shape[1]}"
              f" C {c} D {d}: max abs err {res[0]:.3e}, rel {res[1]:.3e}; "
              f"kernel {res[2]:.3f} ms, plain {res[3]:.3f} ms")
    maps16 = backbone_maps(rulebook(fields16), key_sorted=True)
    for name, _, _, table_stage, c, d in WINDOW_LAYERS:
        m = maps16[_map_key(name)]
        rows = m.fwd.shape[1]
        table = torch.randn((1, caps16[table_stage], c), device=dev,
                            generator=gen)
        dout = torch.randn((1, rows, d), device=dev, generator=gen)
        w = weights(c, d)
        if name != "conv_input":          # no gradient to the voxel inputs
            wt = m.dgrad_weights(w)
            res = _time_pair(f"subm_conv dgrad {name}",
                             lambda: subm_conv(dout, m.bwd, wt),
                             lambda: subm_conv_plain(dout, m.bwd, wt))
            add(k3, res)
            print(f"subm_conv dgrad {name}: R {m.bwd.shape[1]} M {rows} C "
                  f"{d} D {c}: max abs err {res[0]:.3e}, rel {res[1]:.3e}; "
                  f"kernel {res[2]:.3f} ms, plain {res[3]:.3f} ms")
        res = _time_pair(f"sparse_wgrad {name}",
                         lambda: sparse_wgrad(table, m.fwd, dout),
                         lambda: sparse_wgrad_plain(table, m.fwd, dout))
        add(k4, res)
        print(f"sparse_wgrad {name}: R {rows} M {table.shape[1]} C {c} D "
              f"{d}: max abs err {res[0]:.3e}, rel {res[1]:.3e}; kernel "
              f"{res[2]:.3f} ms, plain {res[3]:.3f} ms")
    print(f"subm_conv, 11 forward + 10 dgrad layers: kernel {k3['ms']:.3f} "
          f"ms, plain {k3['plain_ms']:.3f} ms; sparse_wgrad, 11 layers: "
          f"kernel {k4['ms']:.3f} ms, plain {k4['plain_ms']:.3f} ms")
    return tuple({"max_abs_err": a["err"], "max_rel_err": a["rel"],
                  "ms": a["ms"], "plain_ms": a["plain_ms"]} for a in (k3, k4))


def _map_key(layer: str) -> str:
    """The rulebook's explicit map of a VoxelBackbone8x layer."""
    for name, win, stage, _, _, _ in WINDOW_LAYERS:
        if name == layer:
            return f"down_{stage}" if win.startswith("dwin") \
                else f"nbr_{stage}"
    raise KeyError(layer)


def _outputs(out):
    """(name, tensor) of every float output field."""
    for name in ("a_theta", "card", "rgb_features", "lidar_features",
                 "fused_features"):
        yield name, getattr(out, name)
    for name in ("pose", "interaction", "sg_pose", "sg_interaction"):
        for i, t in enumerate(getattr(out, name)):
            yield f"{name}[{i}]", t


def _model(cfg, device):
    import torch
    from multimodal_gar_tpu_torch.models import MGAR
    from multimodal_gar_tpu_torch.utils.testing import randomize_
    model = MGAR(cfg, device=device,
                 generator=torch.Generator().manual_seed(0))
    randomize_(model, torch.Generator().manual_seed(1))
    return model


def phase_tiny():
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, synthetic_batch_numpy, tiny_config)
    cfg = tiny_config()
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    ref = make_eval_step(_model(cfg, "cpu"))(batch_from_numpy(fields))
    got = make_eval_step(_model(cfg, "cuda"))(
        batch_from_numpy(fields, "cuda")).to("cpu")
    refs = dict(_outputs(ref))
    worst = 0.0
    for name, t in _outputs(got):
        _, rel = rel_err(t, refs[name])
        check(rel <= MODEL_TOL, f"tiny forward {name}: rel err {rel}")
        worst = max(worst, rel)
    check(torch.equal(got.group_ids, ref.group_ids), "group_ids differ")
    print(f"tiny_config forward, card vs CPU: max rel err {worst:.3e} over "
          f"{len(list(_outputs(got)))} outputs, group_ids equal")


def phase_tiny_train():
    """One train step's forward and backward, card against CPU."""
    import torch
    from multimodal_gar_tpu_torch.utils.testing import (
        BN_CANCELLED_BIASES, batch_from_numpy, condition_for_grad_parity_,
        prepare_grad_parity_, synthetic_batch_numpy, tiny_config,
        train_loss_and_grads)
    cfg = tiny_config()
    fields = condition_for_grad_parity_(
        synthetic_batch_numpy(cfg, batch_size=2, seed=0))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = prepare_grad_parity_(_model(cfg, dev))
        loss, grads, stats = train_loss_and_grads(
            model, batch_from_numpy(fields, dev))
        runs[dev] = (loss.cpu(), {k: v.cpu() for k, v in grads.items()},
                     {k: v.cpu() for k, v in stats.items()})
    (ref_loss, ref_g, ref_s), (loss, grads, stats) = runs["cpu"], runs["cuda"]
    _, rel = rel_err(loss, ref_loss)
    check(rel <= MODEL_TOL, f"tiny train loss rel err {rel}")
    worst_g = worst_s = 0.0
    for k, g in grads.items():
        if k in BN_CANCELLED_BIASES:
            scale = ref_g[k.replace(".bias", ".weight")].abs().max().item()
            for side in (g, ref_g[k]):
                check(side.abs().max().item() <= NOISE_TOL * scale,
                      f"tiny train gradient {k} is not rounding noise")
            continue
        _, r = rel_err(g, ref_g[k])
        check(r <= MODEL_TOL, f"tiny train gradient {k}: rel err {r}")
        worst_g = max(worst_g, r)
    for k, v in stats.items():
        _, r = rel_err(v, ref_s[k])
        check(r <= MODEL_TOL, f"tiny train statistic {k}: rel err {r}")
        worst_s = max(worst_s, r)
    check(torch.count_nonzero(grads[
        "lidar_backbone.backbone3d.conv_input.conv.weight"]) > 0,
        "the sparse conv weights got no gradient")
    print(f"tiny_config train step, card vs CPU: loss {loss.item():.6f} rel "
          f"err {rel:.3e}; {len(grads)} gradients max rel err {worst_g:.3e};"
          f" {len(stats)} BN statistics max rel err {worst_s:.3e}")


def check_outputs(out, valid) -> None:
    """Finite, masked, eval-diagonal and softmax invariants of one output."""
    import torch
    invalid = ~valid
    for name, t in _outputs(out):
        check(torch.isfinite(t).all(), f"{name} not finite")
    a = out.a_theta
    diag = torch.diagonal(a, dim1=1, dim2=2)
    check(torch.all(diag[valid] == 1), "a_theta diagonal != 1")
    check(torch.all(a[invalid] == 0)
          and torch.all(a.transpose(1, 2)[invalid] == 0),
          "padded a_theta rows not zero")
    for name, t in _outputs(out):
        if name not in ("a_theta", "card"):
            check(torch.all(t[invalid] == 0), f"padded {name} rows not zero")
    for p in out.pose:
        check(torch.allclose(p[valid].sum(-1),
                             torch.ones_like(p[valid][:, 0])),
              "pose rows do not sum to 1")


def _counters():
    from multimodal_gar_tpu_torch.ops.kernels import (sparse_wgrad, stem_conv,
                                                      subm_conv, window_conv)
    return {"stem_conv": stem_conv.stem_conv,
            "window_conv": window_conv.window_conv,
            "subm_conv": subm_conv.subm_conv,
            "sparse_wgrad": sparse_wgrad.sparse_wgrad}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def phase_full(fields):
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config)
    cfg = flagship_config()
    batch = batch_from_numpy(fields, "cuda")
    eval_step = make_eval_step(_model(cfg, "cuda"))
    eval_step(batch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times = []
    for i in range(3):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ran = {k: v - before[k] for k, v in _counts().items()}
        check(ran["stem_conv"] == 1, "stem kernel launches != 1")
        check(ran["window_conv"] == 11, "window_conv launches != 11")
        check_outputs(out, batch.person_valid)
        print(f"request {i}: {times[-1]:.2f} ms, stem launches "
              f"{ran['stem_conv']}, window_conv launches "
              f"{ran['window_conv']}, outputs finite and masked")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"full width (1 x 15 x 720 x 1280, 100 actors, 40k voxels): "
          f"per-request ms {[round(t, 2) for t in times]}, peak device "
          f"memory {peak:.2f} GiB")
    check(launches["stem_conv"] > 0 and launches["window_conv"] > 0,
          f"a kernel of the path never launched: {launches}")
    return launches, out


def phase_full_nbr(fields, xw_out) -> dict:
    """3 full-width eval requests on the nbr-map path, held to the x-window
    path's outputs (xw_out, the same batch and weights)."""
    import dataclasses
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config)
    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lidar=dataclasses.replace(cfg.model.lidar,
                                             x_window=False)))
    batch = batch_from_numpy(fields, "cuda")
    eval_step = make_eval_step(_model(cfg, "cuda"))
    eval_step(batch)                                   # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    refs = dict(_outputs(xw_out))
    for i in range(3):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        now = _counts()
        check(now["subm_conv"] - before["subm_conv"] == 11,
              "subm_conv launches != 11 on the nbr-map path")
        check(now["window_conv"] == before["window_conv"],
              "window_conv launched on the nbr-map path")
        check(now["stem_conv"] - before["stem_conv"] == 1,
              "stem kernel launches != 1")
        check_outputs(out, batch.person_valid)
        worst = 0.0
        for name, t in _outputs(out):
            _, rel = rel_err(t, refs[name])
            check(rel <= MODEL_TOL, f"nbr-map {name} vs x-window: rel err "
                  f"{rel}")
            worst = max(worst, rel)
        check(torch.equal(out.group_ids, xw_out.group_ids),
              "nbr-map group_ids differ from the x-window path's")
        print(f"nbr-map request {i}: {times[-1]:.2f} ms, subm_conv launches "
              f"11, window_conv 0; outputs vs x-window max rel err "
              f"{worst:.3e}, group_ids equal")
    return _counts()


def _people_on_voxels(fields: dict, cfg) -> dict:
    """The batch with each valid person's 3D box centred on an occupied
    voxel. The synthetic sweep scatters its voxels uniformly over 200 x 200
    x 50 m, so boxes placed independently of it find no voxel within the
    grid pool's radii and the sparse backbone would get no gradient; in a
    real sweep people carry their own points."""
    import numpy as np
    pc = cfg.data.point_cloud
    out = dict(fields)
    boxes = fields["boxes3d"].copy()
    valid = fields["person_valid"][0]
    coords = fields["voxel_coords"][0][fields["voxel_valid"][0]]
    pick = coords[np.linspace(0, len(coords) - 1, int(valid.sum()))
                  .astype(int)]
    centres = (pick[:, ::-1] + 0.5) * np.asarray(pc.voxel.voxel_size) \
        + np.asarray(pc.range[:3])
    boxes[0, valid, :3] = centres.astype(np.float32)
    out["boxes3d"] = boxes
    return out


def phase_train(fields) -> dict:
    """16 full-width micro-steps at the 16k training cap, accumulation 8."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import (make_optimizer,
                                                            make_train_step)
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config)
    cfg = flagship_config(max_voxels=16000)
    accum = cfg.train.grad_accum_steps
    check(accum == 8, f"mil3 accumulates 8 steps, config says {accum}")
    batch = batch_from_numpy(_people_on_voxels(fields, cfg), "cuda")
    model = _model(cfg, "cuda")
    opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                         steps_per_epoch=64, grad_accum=accum,
                         gamma=cfg.train.lr_decay_gamma)
    step = make_train_step(model, opt, "L_total")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    per_step = {"stem_conv": 1, "window_conv": 11, "subm_conv": 10,
                "sparse_wgrad": 11}
    times = []
    prev = [p.detach().clone() for p in opt.params]
    for i in range(1, 2 * accum + 1):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        now = _counts()
        for k, n in per_step.items():
            check(now[k] - before[k] == n, f"micro-step {i}: {k} launches "
                  f"{now[k] - before[k]} != {n}")
        loss = metrics["loss"].item()
        check(math.isfinite(loss), f"micro-step {i}: loss {loss}")
        check(metrics["nonfinite_grads"].item() == 0.0,
              f"micro-step {i}: non-finite gradients")
        moved = [not torch.equal(p, q) for p, q in zip(opt.params, prev)]
        if i % accum:
            check(not any(moved), f"micro-step {i}: {sum(moved)} parameters "
                  f"moved before the accumulation completed")
        else:
            # Adam moves exactly the tensors whose mean gradient so far is
            # not zero (with random weights some heads saturate past the
            # BCE clip, and L_total leaves card_net out: zero gradients)
            m1 = [opt.adam.state[p]["exp_avg"].abs().max().item()
                  for p in opt.params]
            check(all(m > 0 for m, mv in zip(m1, moved) if mv)
                  and all(mv for m, mv in zip(m1, moved) if m > 1e-12)
                  and any(moved), f"micro-step {i}: {sum(moved)} "
                  f"parameters moved, {sum(m > 0 for m in m1)} had a "
                  f"gradient")
            still = [n for (n, p), m in zip(
                ((n, p) for n, p in model.named_parameters()
                 if p.requires_grad), m1) if m == 0]
            sparse = [j for j, (n, p) in enumerate(
                (n, p) for n, p in model.named_parameters()
                if p.requires_grad) if ".backbone3d." in n
                and n.endswith("conv.weight")]
            check(len(sparse) == 11 and all(moved[j] for j in sparse),
                  f"micro-step {i}: a sparse conv weight did not move")
            print(f"update {opt.updates}: {sum(moved)} of {len(moved)} "
                  f"parameter tensors moved; zero gradient: {still[:12]}"
                  f"{' ...' if len(still) > 12 else ''}")
        prev = [p.detach().clone() for p in opt.params]
        print(f"train micro-step {i}: {times[-1]:.2f} ms, loss {loss:.6f}, "
              f"parameters moved {sum(moved)}, launches "
              f"{ {k: now[k] - before[k] for k in per_step} }")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"full-width train (1 x 15 x 720 x 1280, 100 actors, 16k voxels, "
          f"accumulation {accum}): median micro-step "
          f"{statistics.median(times):.2f} ms (steps 2-16: "
          f"{statistics.median(times[1:]):.2f} ms), {opt.updates} updates, "
          f"peak device memory {peak:.2f} GiB")
    check(opt.updates == 2, f"{opt.updates} optimizer updates, expected 2")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_gar_tpu_torch.utils.testing import (flagship_config,
                                                        synthetic_batch_numpy)
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        stem = phase_stem(gen)
        t0 = time.perf_counter()
        cfg = flagship_config()
        fields = synthetic_batch_numpy(cfg, batch_size=1, seed=0, n_valid=100)
        cfg16 = flagship_config(max_voxels=16000)
        fields16 = synthetic_batch_numpy(cfg16, batch_size=1, seed=0,
                                         n_valid=100)
        print(f"flagship synthetic batches + rulebooks (40k, 16k voxels): "
              f"{time.perf_counter() - t0:.1f} s")
        caps = cfg.model.lidar.max_voxels_per_stage
        window = phase_window(fields, caps, gen)
        subm, wgrad = phase_subm_wgrad(
            fields, caps, fields16, cfg16.model.lidar.max_voxels_per_stage,
            gen)
    phase_tiny()
    phase_tiny_train()
    eval_counts, xw_out = phase_full(fields)
    nbr_counts = phase_full_nbr(fields, xw_out)
    train_counts = phase_train(fields16)
    launches = {k: eval_counts[k] + nbr_counts[k] + train_counts[k]
                for k in eval_counts}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main paths never launched: {launches}")
    kernels = [
        {"name": "stem_conv", "route": "cuda", "source": f"{SRC}/stem_conv.cu",
         "replaces": "multimodal_gar_tpu/ops/pallas/stem_conv.py:390",
         "launches": launches["stem_conv"], **stem},
        {"name": "window_conv", "route": "cuda",
         "source": f"{SRC}/window_conv.cu",
         "replaces": "multimodal_gar_tpu/ops/pallas/window_conv.py:220",
         "launches": launches["window_conv"], **window},
        {"name": "subm_conv", "route": "cuda", "source": f"{SRC}/subm_conv.cu",
         "replaces": "multimodal_gar_tpu/ops/pallas/subm_conv.py:69",
         "launches": launches["subm_conv"], **subm},
        {"name": "sparse_wgrad", "route": "cuda",
         "source": f"{SRC}/sparse_wgrad.cu",
         "replaces": "multimodal_gar_tpu/models/sparse_backbone.py:172",
         "launches": launches["sparse_wgrad"], **wgrad},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
