"""The Voxel R-CNN family: the port's ``VoxelRCNN-Det`` built by
``models/registry.py: build_model`` at a configuration file's sizes, fed
``data/detbatch.py: assemble_det_batch`` batches of the benchmark's own
frames and trained through ``detection/train.py: make_det_train_step``
with the file's optimizer (``adam_onecycle``).

``Cell(spec)`` runs one cell: ``setup`` builds the program and the input
pool from the seed, takes the first steps (the checked ones, which warm up
every shape) and reads them, ``window`` measures, ``release`` frees the
program's state, ``checks`` holds the readings to the plain reference
(reference/voxelrcnn.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from harness import Trace, load_module, load_weights_, sync


@dataclasses.dataclass
class Sample:
    """One step's input: the program's batch (host tensors, pinned on a
    card) and the benchmark-made frames it was assembled from."""
    batch: object
    frames: List[dict]
    max_gt: int


class _Frames:
    """The frame provider ``assemble_det_batch`` reads."""

    def __init__(self, frames: List[dict], point_range):
        self.frames = frames
        self.range = np.asarray(point_range, np.float32)

    def frame(self, idx: int) -> dict:
        return self.frames[idx]


def _pinned(batch, on_cuda: bool):
    if not on_cuda:
        return batch
    fields = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, dict):
            v = {k: t.pin_memory() for k, t in v.items()}
        elif isinstance(v, torch.Tensor):
            v = v.pin_memory()
        fields[f.name] = v
    return type(batch)(**fields)


def program_model(cfgj: dict, seed: int, device):
    """The port's VoxelRCNN-Det of the configuration file, through
    ``build_model``, with the weights drawn from ``seed``."""
    from multimodal_gar_tpu_torch.config import (Config,
                                                 LiDARBackboneConfig)
    from multimodal_gar_tpu_torch.detection.detectors import DetectorConfig
    from multimodal_gar_tpu_torch.detection.roi_detectors import (
        RoIHeadConfig)
    from multimodal_gar_tpu_torch.detection.train import OneCycleConfig
    from multimodal_gar_tpu_torch.models.registry import build_model
    from harness import apply_overrides
    ref = load_module("reference", "voxelrcnn.py")
    det, roi, pool, cycle = ref.configs(cfgj, {
        "DetectorConfig": DetectorConfig, "RoIHeadConfig": RoIHeadConfig,
        "LiDARBackboneConfig": LiDARBackboneConfig,
        "OneCycleConfig": OneCycleConfig})
    d, v = cfgj["detector"], cfgj["voxelization"]
    cfg = apply_overrides(Config(), {"data": {"point_cloud": {
        "range": d["point_cloud_range"],
        "num_point_features": v["num_point_features"],
        "voxel": {"voxel_size": d["voxel_size"]}}}})
    model = build_model(cfg, d["name"], device=device,
                        generator=torch.Generator().manual_seed(0),
                        det_cfg=det, roi_cfg=roi, lidar_cfg=pool)
    load_weights_(model, ref.seeded_detector_weights(model.state_dict(), seed,
                                                     device))
    return model, cycle


class Cell:
    """One Voxel R-CNN training cell; ``spec`` carries the workload,
    configuration and mix files, the seed and the device."""

    family = "voxelrcnn"

    def __init__(self, spec: dict):
        self.spec = spec
        self.wl, self.cfgj, self.mix = spec["workload"], spec["config"], \
            spec["mix"]
        self.seed = spec["seed"]
        self.device = torch.device(spec["device"])
        self.loop = self.wl["loop"]
        if self.loop != "train":
            raise ValueError("the voxelrcnn family has training cells only")
        self.records: dict = {}

    # -- set-up -------------------------------------------------------------
    def setup(self, clock) -> None:
        on_cuda = self.device.type == "cuda"
        build = 0.0
        if on_cuda:
            from multimodal_gar_tpu_torch.ops.kernels import (
                neighbour_gather, nms_bev, sparse_wgrad, subm_conv)
            from multimodal_gar_tpu_torch.ops.kernels._build import load_all
            libs = [m.LIBRARY for m in (subm_conv, sparse_wgrad,
                                        neighbour_gather, nms_bev)]
            load_all(libs)
            build = sum(lib.build_seconds or 0.0 for lib in libs)
        self.records["build_seconds"] = build
        clock.mark("nvcc")
        self.model, self.one_cycle = program_model(self.cfgj, self.seed,
                                                   self.device)
        clock.mark("weights")
        self.pool = self._pool(on_cuda)
        self.pool_size = len(self.pool)
        clock.mark("input_pool")
        self._setup_train()
        sync(self.device)
        clock.mark("warmup")

    def _pool(self, on_cuda: bool) -> List[Sample]:
        """The mix's frames in a seeded order, two to a step."""
        from multimodal_gar_tpu_torch.data.detbatch import assemble_det_batch
        gen = load_module("traffic", f"{self.mix['generator']}.py")
        p, n = self.mix["params"], self.mix["pool"]
        frames = [gen.frame(p, self.seed, i, n) for i in range(n)]
        order = np.random.default_rng(
            [int(self.seed) % (2 ** 63), 41]).permutation(n)
        d, v = self.cfgj["detector"], self.cfgj["voxelization"]
        b = self.wl["batch"]
        out = []
        for k in range(n // b):
            pair = [frames[i] for i in order[k * b:(k + 1) * b]]
            batch = assemble_det_batch(
                _Frames(pair, d["point_cloud_range"]), range(b),
                d["voxel_size"], v["max_voxels_train"],
                v["max_points_per_voxel"], max_points=1,
                max_gt=p["max_gt"],
                rulebook_caps=tuple(self.cfgj["stage_caps"]["train"]),
                num_features=v["num_point_features"], device="cpu")
            out.append(Sample(_pinned(batch, on_cuda), pair, p["max_gt"]))
        return out

    def _setup_train(self) -> None:
        from multimodal_gar_tpu_torch.detection.train import (
            create_det_train_state, make_det_train_step)
        opt = self.cfgj["optimizer"]
        self.state = create_det_train_state(
            self.model, weight_decay=opt["weight_decay"],
            clip_norm=opt["grad_norm_clip"], optimizer=opt["name"],
            one_cycle=self.one_cycle)
        self.step = make_det_train_step(self.model, self.state,
                                        seed=self.spec["dropout_seed"])
        compare = load_module("reference", "compare.py")
        ref = load_module("reference", "voxelrcnn.py")
        proposals: list = []
        handle = ref.capture_proposals(self.model, proposals)
        readings = compare.train_readings(
            self.model, self.state.params, self.state.optimizer,
            self._micro_step, self.wl["checked_updates"], 1, self.pool_size)
        handle.remove()
        readings["proposals"] = proposals[:1]
        self.records["train_readings"] = readings

    def _micro_step(self, idx: int):
        return self.step(self.pool[idx].batch.to(self.device))

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, trace: bool, trace_seconds: float
               ) -> dict:
        from multimodal_gar_tpu_torch.utils import profiling
        prof = Trace(self.device) if trace else None
        counts = load_module("counts", f"{self.family}.py")
        per_step = [counts.step_counts(self.cfgj, s.batch, self.device)
                    for s in self.pool] if trace else None
        if trace:
            profiling.reset_spans()
            profiling.reset_counters()
        served: List[int] = []
        lat: List[float] = []
        sync(self.device)
        if trace:
            prof.start()
        traced_until = None
        t_start = time.perf_counter()
        i = 0
        while True:
            idx = i % self.pool_size
            t0 = time.perf_counter()
            self._micro_step(idx)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            served.append(idx)
            i += 1
            if trace and traced_until is None and \
                    t1 - t_start >= trace_seconds:
                prof.stop()
                traced_until = i
                t_traced = time.perf_counter()
            if t1 - t_start >= seconds:
                break
        sync(self.device)
        t_end = time.perf_counter()
        rec = {"loop": self.loop, "requests": len(served),
               "elapsed_s": t_end - t_start, "latencies_s": lat,
               "start_lag_s": [], "batch": self.wl["batch"]}
        if trace:
            if traced_until is None:
                prof.stop()
                traced_until = len(served)
                t_traced = time.perf_counter()
            rec.update(prof.result())
            after = served[traced_until:]
            rec["untraced"] = {"seconds": t_end - t_traced,
                               "requests": len(after),
                               "counts": counts.total(per_step, after)}
            traced = counts.total(per_step, served[:traced_until])
            traced.update(counts.nms_counts(
                self.cfgj, profiling.counter_values(),
                traced_until * self.wl["batch"]))
            rec["traced_counts"] = traced
        self.records.update(rec)
        return rec

    # -- after the window ---------------------------------------------------
    def release(self) -> None:
        """Free the program's state on the device, keeping the host pool
        and the readings."""
        for attr in ("model", "step", "state"):
            if hasattr(self, attr):
                delattr(self, attr)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self) -> List[dict]:
        ref = load_module("reference", "voxelrcnn.py")
        compare = load_module("reference", "compare.py")
        limits = self.cfgj["limits"][self.loop]
        got = self.records["train_readings"]
        want = ref.train_readings(self.cfgj, self.wl, self.seed,
                                  self.spec["dropout_seed"], self.pool,
                                  self.device)
        checks = compare.train_checks(got, want, limits)
        share = ref.proposal_mismatch_share(got["proposals"],
                                            want["proposals"])
        limit = limits.get("proposal_mismatch_share")
        checks.append({"name": "proposal_mismatch_share", "value": share,
                       "limit": limit,
                       "ok": limit is not None and share <= limit})
        return checks
