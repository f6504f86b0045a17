"""The MGAR family: the port's ``MGAR`` at a configuration file's sizes,
served one clip at a time through ``make_eval_step`` or trained through
``make_train_step`` with ``AccumulatingAdam``.

``Cell(spec)`` runs one cell: ``setup`` builds the program and the input
pool from the seed and warms up, ``window`` measures, ``release`` frees
the program's state, ``checks`` holds the recorded outputs to the plain
reference (reference/mgar.py).
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from harness import (Spans, Trace, load_module, load_weights_, make_config,
                     seeded_weights, sync)

def sizes(cfg) -> dict:
    """The sizes the traffic generator reads."""
    d = cfg.data
    return {"num_boxes": d.num_boxes, "image_size": tuple(d.image_size),
            "num_actions": d.num_actions, "num_frames": d.num_frames}


def host_fields(mix: dict, seed: int, index: int, cfg, loop: str) -> dict:
    """Clip ``index`` as padded numpy batch fields (batch size 1) with the
    voxels at the loop's cap, made by the benchmark alone."""
    gen = load_module("traffic", f"{mix['generator']}.py")
    vox = load_module("traffic", "voxelize.py")
    c = gen.clip(mix["params"], seed, index, sizes(cfg), mix["pool"])
    pc = cfg.data.point_cloud
    cap = pc.voxel.max_voxels(loop == "train")
    out = vox.Voxelizer(pc.voxel.voxel_size, pc.range,
                        pc.voxel.max_points_per_voxel, cap)(c["points"])
    voxels, coords, nump, valid = vox.pad_voxels(
        out, cap, pc.num_point_features, pc.voxel.max_points_per_voxel)
    fields = {k: c[k] for k in ("boxes2d", "boxes3d", "person_valid",
                                "social_group_id", "actions",
                                "social_group_activity")}
    fields.update(voxels=voxels, voxel_coords=coords,
                  voxel_num_points=nump, voxel_valid=valid)
    fields = {k: v[None] for k, v in fields.items()}
    fields["seq_id"] = np.zeros((1,), np.int32)
    fields["frame_id"] = np.full((1,), index, np.int32)
    return fields


def pinned(t: torch.Tensor, on_cuda: bool) -> torch.Tensor:
    return t.pin_memory() if on_cuda else t


class Cell:
    """One MGAR cell; ``spec`` carries the workload, configuration and mix
    files, the seed and the device."""

    family = "mgar"

    def __init__(self, spec: dict):
        self.spec = spec
        self.wl, self.cfgj, self.mix = spec["workload"], spec["config"], \
            spec["mix"]
        self.seed = spec["seed"]
        self.device = torch.device(spec["device"])
        self.loop = self.wl["loop"]
        self.pool_size = self.mix["pool"]
        self.records: dict = {}

    # -- set-up -------------------------------------------------------------
    def setup(self, clock) -> None:
        from multimodal_gar_tpu_torch.config import Config
        from multimodal_gar_tpu_torch.models.mgar import MGAR
        from multimodal_gar_tpu_torch.types import Batch
        on_cuda = self.device.type == "cuda"
        build = 0.0
        if on_cuda:
            from multimodal_gar_tpu_torch.ops.kernels import (
                sparse_wgrad, stem_conv, subm_conv, window_conv)
            from multimodal_gar_tpu_torch.ops.kernels._build import load_all
            libs = [m.LIBRARY for m in (stem_conv, window_conv, subm_conv,
                                        sparse_wgrad)]
            load_all(libs)
            build = sum(lib.build_seconds or 0.0 for lib in libs)
        self.records["build_seconds"] = build
        clock.mark("nvcc")
        self.cfg = make_config(Config, self.cfgj, self.loop)
        self.model = MGAR(self.cfg, device=self.device,
                          generator=torch.Generator().manual_seed(0))
        load_weights_(self.model, seeded_weights(
            self.model.state_dict(), self.seed, self.device))
        clock.mark("weights")
        self.pool = [self._clip(i, Batch, on_cuda)
                     for i in range(self.pool_size)]
        clock.mark("input_pool")
        if self.loop == "eval":
            from multimodal_gar_tpu_torch.train.train_state import (
                make_eval_step)
            self.step = make_eval_step(self.model)
            for i in range(self.wl["warmup_requests"]):
                self._request(i % self.pool_size)
        else:
            self._setup_train()
        sync(self.device)
        clock.mark("warmup")

    def _clip(self, index: int, Batch, on_cuda: bool):
        from multimodal_gar_tpu_torch.data.rulebook import build_rulebook
        fields = host_fields(self.mix, self.seed, index, self.cfg, self.loop)
        pc = self.cfg.data.point_cloud
        nx, ny, nz = pc.grid_size
        rb = build_rulebook(fields["voxel_coords"][0],
                            int(fields["voxel_valid"][0].sum()),
                            (nz + 1, ny, nx),
                            self.cfg.model.lidar.max_voxels_per_stage)
        gen = load_module("traffic", f"{self.mix['generator']}.py")
        images = gen.frames(self.mix["params"], self.seed, index,
                            sizes(self.cfg), self.device)[None]
        batch = {k: pinned(torch.from_numpy(np.ascontiguousarray(v)),
                           on_cuda) for k, v in fields.items()}
        batch["images"] = pinned(images.cpu(), on_cuda)
        batch["rulebook"] = {k: pinned(torch.from_numpy(
            np.ascontiguousarray(np.asarray(v)[None])), on_cuda)
            for k, v in rb.items()}
        return Batch(**batch)

    def _request(self, idx: int):
        """One served request: transfer, eval step, outputs on the host."""
        out = self.step(self.pool[idx].to(self.device))
        return out.to("cpu")

    def _setup_train(self) -> None:
        from multimodal_gar_tpu_torch.train.train_state import (
            TrainState, make_optimizer, make_train_step)
        tr = self.cfg.train
        self.accum = tr.grad_accum_steps
        self.opt = make_optimizer(
            self.model.parameters(), tr.stages[0],
            steps_per_epoch=self.wl["steps_per_epoch"],
            grad_accum=self.accum, gamma=tr.lr_decay_gamma)
        self.state = TrainState(model=self.model, optimizer=self.opt)
        self.step = make_train_step(self.model, self.opt, tr.stages[0].loss,
                                    state=self.state,
                                    seed=self.spec["dropout_seed"])
        compare = load_module("reference", "compare.py")
        self.records["train_readings"] = compare.train_readings(
            self.model, self.opt.params, self.opt.adam, self._micro_step,
            self.wl["checked_updates"] * self.accum, self.accum,
            self.pool_size)

    def _micro_step(self, idx: int):
        return self._train_call(self.pool[idx].to(self.device))

    def _train_call(self, batch):
        """One micro-step on a batch on the device; the caller keeps
        ``state.step`` at the micro-steps taken, as ``run_training``."""
        metrics = self.step(batch)
        self.state.step += 1
        return metrics

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, trace: bool, trace_seconds: float
               ) -> dict:
        spans = Spans(self.device) if trace else None
        if trace:
            self._hook(spans)
        prof = Trace(self.device) if trace else None
        counts = load_module("counts", f"{self.family}.py")
        per_clip = [counts.request_counts(self.cfgj, self.cfg, self.pool[i],
                                          self.loop, self.device)
                    for i in range(self.pool_size)] if trace else None
        served: List[int] = []
        lat: List[float] = []
        lag: List[float] = []
        dispatch: List[float] = []
        self.outputs = {}
        # eval: requests due at a fixed rate (an open loop), each served when
        # due or when the one before it ends; latency from when it was due.
        # train, and a traced run of either: back to back, so that the
        # per-layer metrics read the service itself.
        rate = self.mix["params"].get("rate_per_s") \
            if self.loop == "eval" and not trace else None
        sync(self.device)
        if trace:
            prof.start()
        traced_until = None
        t_start = time.perf_counter()
        i = 0
        while True:
            idx = i % self.pool_size
            if rate:
                due = t_start + i / rate
                if due >= t_start + seconds:
                    break
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                lag.append(time.perf_counter() - due)
            if not rate:
                due = time.perf_counter()
            if spans:
                spans.begin("h2d")
            batch = self.pool[idx].to(self.device)
            if spans:
                spans.end("h2d")
            if self.loop == "eval":
                h0 = time.perf_counter()
                out = self.step(batch)
                dispatch.append((time.perf_counter() - h0) * 1e3)
                self.outputs[idx] = out.to("cpu")
            else:
                self._train_call(batch)
                if spans:
                    spans.end("after_forward")
            t1 = time.perf_counter()
            lat.append(t1 - due)
            served.append(idx)
            i += 1
            if trace and traced_until is None and \
                    t1 - t_start >= trace_seconds:
                prof.stop()
                traced_until = i
                t_traced = time.perf_counter()
            if not rate and t1 - t_start >= seconds:
                break
        sync(self.device)
        t_end = time.perf_counter()
        elapsed = t_end - t_start
        rec = {"loop": self.loop, "requests": len(served),
               "elapsed_s": elapsed, "latencies_s": lat,
               "start_lag_s": lag, "batch": self.wl["batch"]}
        if trace:
            if traced_until is None:
                prof.stop()
                traced_until = len(served)
                t_traced = time.perf_counter()
            spans.remove()
            rec.update(prof.result())
            rec["spans_ms"] = spans.ms()
            rec["host_dispatch_ms"] = dispatch
            after = served[traced_until:]
            rec["untraced"] = {"seconds": t_end - t_traced,
                               "requests": len(after),
                               "counts": counts.total(per_clip, after)}
            rec["traced_counts"] = counts.total(per_clip,
                                                served[:traced_until])
        self.records.update(rec)
        return rec

    def _hook(self, spans: Spans) -> None:
        m = self.model
        if self.loop == "eval":
            spans.hook("rgb_branch", m.rgb_backbone)
            spans.hook("lidar_branch", m.lidar_backbone)
            spans.hook("fusion_heads", m.gar_fusion)
        else:
            spans.hook_step(m)
            spans.hook("grid_pool", m.lidar_backbone.roi_grid_pool)

    # -- after the window -------------------------------------------------------
    def release(self) -> None:
        """Free the program's state on the device, keeping the host pool
        and the recorded outputs."""
        for attr in ("model", "step", "opt", "state"):
            if hasattr(self, attr):
                delattr(self, attr)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self) -> List[dict]:
        ref = load_module("reference", "mgar.py")
        compare = load_module("reference", "compare.py")
        limits = self.cfgj["limits"][self.loop]
        if self.loop == "eval":
            fields = {idx: self.pool[idx] for idx in sorted(self.outputs)}
            got = {idx: compare.flat_outputs(o)
                   for idx, o in self.outputs.items()}
            want = ref.eval_outputs(self.cfgj, self.seed, fields,
                                    self.device)
            return compare.eval_checks(got, want, limits)
        readings = self.records["train_readings"]
        want = ref.train_readings(self.cfgj, self.wl, self.seed,
                                  self.spec["dropout_seed"], self.pool,
                                  self.device)
        return compare.train_checks(readings, want, limits)
