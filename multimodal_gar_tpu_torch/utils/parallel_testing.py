"""Multi-process runs of the parallel layer (parallel/) for the tests and
chip_smoke.py.

``spawn(world, job, workdir)`` starts ``world`` processes of this module.
Each joins a gloo group over a file store in ``workdir`` (on the CPU, or
with CUDA tensors on one card: gloo takes CUDA tensors for its all-reduce
and broadcast, where NCCL refuses two ranks on one GPU), lays the job's
('data', 'fsdp') mesh over it, runs the job's cases in order and saves
what they return. The case functions run as well in a single process
without a mesh, which gives the reference to hold the ranks to.

    python -m multimodal_gar_tpu_torch.utils.parallel_testing WORKDIR RANK WORLD

is one such process; the job is ``WORKDIR/job.pt``, the results
``WORKDIR/rank<RANK>.pt``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast")


def spawn(world: int, job: dict, workdir: str,
          timeout: float = 300.0) -> List[dict]:
    """Run ``job`` in ``world`` processes; returns each rank's results.
    ``job``: {"mesh": (data, fsdp), "device": "cpu" | "cuda", "threads":
    torch threads per process, "cases": [(label, case name, kwargs)]}.
    Raises with the processes' output when one fails or the time runs
    out (then every process is killed). The files it writes in
    ``workdir`` are removed once the results are read."""
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        if name == "store" or name.startswith("rank"):
            os.remove(os.path.join(workdir, name))
    torch.save(job, os.path.join(workdir, "job.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, workdir, str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            outputs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{world} processes did not finish in "
                           f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n"
                          f"{outputs[r][-4000:]}" for r in failed)
        raise RuntimeError(f"ranks {failed} failed:\n{tails}")
    results = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    for name in ["job.pt", "store"] + [f"rank{r}.pt" for r in range(world)]:
        path = os.path.join(workdir, name)
        if os.path.exists(path):
            os.remove(path)
    return results


def _main(workdir: str, rank: int, world: int) -> None:
    from ..config import MeshConfig
    from ..parallel.mesh import make_mesh
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    torch.set_num_threads(job.get("threads", 2))
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    try:
        data, fsdp = job["mesh"]
        mesh = make_mesh(MeshConfig(data=data, fsdp=fsdp), device)
        results = {label: CASES[name](mesh=mesh, device=device, **kwargs)
                   for label, name, kwargs in job["cases"]}
        path = os.path.join(workdir, f"rank{rank}.pt")
        torch.save(results, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


# -- what the cases record ----------------------------------------------------

def _sent(name: str, args) -> torch.Tensor:
    """The tensor a collective ``name`` called with ``args`` sends."""
    return args[1] if name in ("all_gather", "all_gather_into_tensor",
                               "reduce_scatter_tensor") else args[0]


@contextlib.contextmanager
def recorded_collectives() -> Iterator[List[dict]]:
    """Within it every collective of ``torch.distributed`` that the port
    calls (COLLECTIVES; the autograd all-reduce of torch.distributed.nn goes
    through ``all_reduce``) is logged: {"op", "shape", "bytes" of the
    tensor it sends, "group" size}."""
    log: List[dict] = []
    originals = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def call(*args, **kwargs):
            sent = _sent(name, args)
            log.append({"op": name, "shape": tuple(sent.shape),
                        "bytes": sent.numel() * sent.element_size(),
                        "group": dist.get_world_size(kwargs.get("group"))})
            return fn(*args, **kwargs)
        return call
    for name, fn in originals.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield log
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


# where this rank is (wait_limit): updated at each micro-step of
# mgar_steps and at each collective the port issues within wait_limit
_WHERE = {"at": "start", "collective": None, "since": time.monotonic()}


def note_progress(at: str) -> None:
    """Mark this rank's progress (``at`` says where) for ``wait_limit``."""
    _WHERE.update(at=at, since=time.monotonic())


@contextlib.contextmanager
def wait_limit(seconds: float, rank: int) -> Iterator[None]:
    """Within it, a rank that makes no progress for ``seconds`` (no
    ``note_progress`` and no collective issued or returned) fails on its
    own: a thread prints the rank, where it was (the micro-step) and the
    last collective it issued, and ends the process with exit code 3. An
    NCCL collective returns before the device has run it, so a rank stuck
    on one is caught at its next synchronisation, and the collective
    named is the last one issued before it."""
    import threading
    originals = {name: getattr(dist, name) for name in COLLECTIVES}
    counts: Dict[str, int] = {}

    def wrap(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            sent = _sent(name, args)
            _WHERE.update(collective=f"{name} #{counts[name]} of shape "
                          f"{tuple(sent.shape)}", since=time.monotonic())
            out = fn(*args, **kwargs)
            _WHERE["since"] = time.monotonic()
            return out
        return call
    done = threading.Event()

    def watch():
        while not done.wait(1.0):
            idle = time.monotonic() - _WHERE["since"]
            if idle > seconds:
                print(f"rank {rank}: no progress for {idle:.0f} s (limit "
                      f"{seconds:g} s) at {_WHERE['at']}; last collective"
                      f" issued: {_WHERE['collective']}", file=sys.stderr,
                      flush=True)
                os._exit(3)
    for name, fn in originals.items():
        setattr(dist, name, wrap(name, fn))
    note_progress("start")
    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    try:
        yield
    finally:
        done.set()
        thread.join()
        for name, fn in originals.items():
            setattr(dist, name, fn)


def _kernel_sites():
    """{kernel: (module, attribute, plain version)}: the functions through
    which the models launch the stem, window_conv, K3 and K4."""
    import multimodal_gar_tpu_torch.models.i3d as i3d
    import multimodal_gar_tpu_torch.ops.kernels.subm_conv as k3m
    import multimodal_gar_tpu_torch.ops.kernels.window_conv as wcm
    from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
        sparse_wgrad_plain)
    from multimodal_gar_tpu_torch.ops.kernels.stem_conv import stem_conv_plain

    def stem_plain(xd, w2, scale, bias, t_pad=(3, 3), **_):
        return stem_conv_plain(xd, w2, scale, bias, t_pad)
    return {"stem_conv": (i3d, "stem_conv", stem_plain),
            "window_conv": (wcm, "_window_forward", wcm.window_conv_plain),
            "subm_conv": (k3m, "_subm_forward", k3m.subm_conv_plain),
            "sparse_wgrad": (k3m, "sparse_wgrad", sparse_wgrad_plain)}


def launch_counts(set_to: Optional[Dict[str, int]] = None
                  ) -> Dict[str, int]:
    """The launch counts of the stem, window_conv, K3 and K4 wrappers in
    this process (each adds one where it launches its kernel), after
    setting them to ``set_to`` where given."""
    from ..ops.kernels import sparse_wgrad, stem_conv, subm_conv, window_conv
    fns = {"stem_conv": stem_conv.stem_conv,
           "window_conv": window_conv.window_conv,
           "subm_conv": subm_conv.subm_conv,
           "sparse_wgrad": sparse_wgrad.sparse_wgrad}
    for k, n in (set_to or {}).items():
        fns[k].launches = n
    return {k: fn.launches for k, fn in fns.items()}


def kernel_checks(run: Callable[[], object]) -> Dict[str, dict]:
    """Runs ``run()`` with every stem, window_conv, K3 and K4 launch
    recorded with a copy of its inputs, then replays each through its
    kernel and its plain version: {kernel: {"launches", "max_abs_err",
    "max_rel_err"}} (error over the largest plain value). The replays
    leave the wrappers' launch counts as ``run()`` left them."""
    sites = _kernel_sites()
    calls = []
    originals = {k: getattr(mod, attr) for k, (mod, attr, _) in sites.items()}

    def recorder(name, fn):
        def launch(*args, **kwargs):
            calls.append((name, [a.detach().clone() for a in args], kwargs))
            return fn(*args, **kwargs)
        return launch
    for name, (mod, attr, _) in sites.items():
        setattr(mod, attr, recorder(name, originals[name]))
    try:
        run()
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, originals[name])
    out = {name: {"launches": 0, "max_abs_err": 0.0, "max_rel_err": 0.0}
           for name in sites}
    counted = launch_counts()
    with torch.no_grad():
        for name, args, kwargs in calls:
            got = originals[name](*args, **kwargs)
            ref = sites[name][2](*args, **kwargs)
            err = (got - ref).abs().max().item()
            row = out[name]
            row["launches"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["max_rel_err"] = max(row["max_rel_err"], err / max(
                ref.abs().max().item(), 1e-30))
    launch_counts(set_to=counted)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device):
    """(fn(), its milliseconds: CUDA events on the card, the host clock on
    the CPU)."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def deterministic_cudnn(on: bool = True) -> Iterator[None]:
    """Within it (where ``on``), cuDNN runs only its deterministic
    algorithms (``cudnn.deterministic``; an autotuned conv times only
    those), so that one batch gives the same bits run after run."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = old or on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


# what ``planted_fault`` replaces in the two train steps' modules
FAULTS = ("bn_local", "local_counts", "no_grad_reduce")


@contextlib.contextmanager
def planted_fault(name: Optional[str]) -> Iterator[None]:
    """Within it, the steps made (``make_train_step``,
    ``make_det_train_step``) carry one deliberate fault of data
    parallelism, so that a check can show it would see the fault:
    "bn_local": the training BatchNorms take their rank's statistics;
    "local_counts": the losses divide by their rank's counts;
    "no_grad_reduce": each rank keeps its own gradients. None: none."""
    if name is None:
        yield
        return
    from ..detection import train as det_train
    from ..models.layers import BatchNorm
    from ..parallel import mesh as mesh_lib
    from ..train import train_state

    def attach_without_bn(model, mesh):
        mesh_lib.attach(model, mesh)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.data_group = None
    attr, fake = {
        "bn_local": ("attach", attach_without_bn),
        "local_counts": ("batch_denominator",
                         lambda mesh: mesh_lib.batch_denominator(None)),
        "no_grad_reduce": ("all_reduce_grads",
                           lambda grads, mesh: list(grads)),
    }[name]
    modules = (train_state, det_train)
    saved = [getattr(m, attr) for m in modules]
    for m in modules:
        setattr(m, attr, fake)
    try:
        yield
    finally:
        for m, orig in zip(modules, saved):
            setattr(m, attr, orig)


def _flip(tree):
    """Every array or tensor of ``tree`` (nested dicts) in the reverse order
    along axis 0; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flip(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.flip(0)
    return tree[::-1]


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def slice_shapes(optimizer) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(full shape, held shape) of each parameter of ``optimizer``: equal
    for an unsharded optimizer, the rank's slice for a ``ShardedAdam``."""
    from ..parallel.mesh import ShardedAdam
    if isinstance(optimizer, ShardedAdam):
        return [(tuple(p.shape), tuple(m.shape))
                for p, m in zip(optimizer.params, optimizer.master)]
    return [(tuple(p.shape), tuple(p.shape)) for p in optimizer.params]


# -- comparing two runs' states -----------------------------------------------

def _require(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def leaf_errors(got, ref, floor=0.0) -> dict:
    """{leaf: (max |got - ref|, max |ref|, floor)} over the floating-point
    leaves of two state dicts (or lists) of tensors; ``floor`` is an
    absolute allowance the caller grants every leaf (Adam's first update
    is lr * sign(g), which a noise-level gradient may flip), or a dict of
    one per leaf."""
    items = got.items() if isinstance(got, dict) else enumerate(got)
    out = {}
    for key, a in items:
        b = ref[key]
        if not b.is_floating_point():
            continue
        err = (a.double() - b.double()).abs().max().item() if a.numel() \
            else 0.0
        scale = b.double().abs().max().item() if b.numel() else 0.0
        out[key] = (err, scale,
                    floor.get(key, 0.0) if isinstance(floor, dict) else floor)
    return out


def spread_floor(ref: dict, other: dict, factor: float,
                 base: float = 0.0) -> dict:
    """{leaf: base + factor * max |ref - other|}: the allowance a leaf gets
    from the spread of one process over the same batch in another sample
    order (float32 sums in another order, the model being invariant to
    it)."""
    return {k: base + factor * err
            for k, (err, _, _) in leaf_errors(ref, other).items()}


def _allowances(errs: dict, tol: float, noise: bool, noise_tol: float):
    """(leaf, error, largest value, floor, what it is allowed, is noise)
    for each leaf under ``check_leaves``' rule."""
    scales = sorted(v for _, v, _ in errs.values() if v > 0)
    typical = scales[len(scales) // 2] if scales else 0.0
    for key, (err, scale, floor) in errs.items():
        if noise and scale < noise_tol * typical:
            yield key, err, scale, floor, noise_tol * typical + floor, True
        else:
            yield key, err, scale, floor, max(tol * scale, floor), False


def check_leaves(errs: dict, tol: float, what: str, noise: bool = False,
                 noise_tol: float = 1e-3) -> tuple:
    """Each leaf's error within ``tol`` of its largest value or within its
    floor. With ``noise`` (gradients), a leaf whose largest value is under
    ``noise_tol`` of the median leaf's is rounding noise (zero in exact
    arithmetic: the biases a training BatchNorm cancels, the layers behind
    a BatchNorm whose scale starts at zero) and is held within
    ``noise_tol`` of that median. Returns (the worst relative error of the
    leaves within ``tol``, [(leaf, relative error, share of its floor)] of
    those past it but within their floor, the number of noise leaves)."""
    worst, floored, n_noise = 0.0, [], 0
    for key, err, scale, floor, allowed, is_noise in _allowances(
            errs, tol, noise, noise_tol):
        _require(err <= allowed,
                 f"{what}: {'noise leaf ' if is_noise else ''}{key} differs "
                 f"by {err:.3e} (largest {scale:.3e}, floor {floor:.3e}, "
                 f"allowed {allowed:.3e})")
        if is_noise:
            n_noise += 1
            continue
        rel = err / scale if scale > 0 else 0.0
        if err > tol * scale:
            floored.append((key, rel, err / floor))
        else:
            worst = max(worst, rel)
    return worst, floored, n_noise


def worst_excess(errs: dict, tol: float, noise: bool = False,
                 noise_tol: float = 1e-3) -> tuple:
    """(the largest error over what ``check_leaves`` allows it, that leaf):
    past 1 the check fails."""
    return max(((err / allowed if allowed > 0 else float("inf")
                 if err > 0 else 0.0), key)
               for key, err, _, _, allowed, _ in _allowances(
                   errs, tol, noise, noise_tol))


# -- the cases ----------------------------------------------------------------

@contextlib.contextmanager
def _default_dtype(dtype: Optional[torch.dtype]):
    """torch's default dtype set to ``dtype`` (None: left as it is) for the
    block, restored after it."""
    previous = torch.get_default_dtype()
    if dtype is not None:
        torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(previous)


def mgar_steps(mesh=None, device="cpu", *, cfg, fields: Optional[dict] = None,
               synthetic: Optional[dict] = None,
               frame_blocks: Optional[int] = None,
               people: Optional[Sequence[int]] = None, reverse: bool = False,
               full_state: bool = False, states: bool = True,
               state_dict: Optional[dict] = None, lr: float = 1e-6,
               steps: int = 1, dropout: bool = True, broken: bool = False,
               check_kernels: bool = False, deterministic: bool = False,
               fault: Optional[str] = None,
               first_moments: bool = False, float64: bool = False) -> dict:
    """``steps`` micro-steps of MGAR(cfg) from ``state_dict`` (None: the
    seeded init) over the global batch ``fields`` (numpy, as
    utils/testing.py's ``synthetic_batch_numpy`` gives them, or made here
    by it from the keywords ``synthetic``, its frames then made of
    ``frame_blocks``-pixel squares where given: utils/testing.py's
    ``block_frames_``; sample b keeps its first ``people[b]`` people where
    given: ``uneven_people_``; with ``reverse`` its samples in the reverse
    order)
    at ``lr``. With a mesh each rank trains on its block (``shard_batch``,
    ``shard_train_state``, ``make_train_step(mesh=)``); ``broken`` instead
    trains every rank on the whole batch without a mesh (no reduction), the
    layout a collective check must refuse.

    Returns the metrics of each micro-step (their mean over the ranks),
    with ``states`` the model's state and the optimizer's full first
    moments after them (with ``full_state`` its whole state_dict), the
    shapes each rank holds, the collectives of the last micro-step, the micro-steps'
    milliseconds, the stem / window_conv / K3 / K4 launches of all of them
    (``launch_counts``) and, with ``check_kernels``, those of the last
    micro-step each replayed against its plain version. ``deterministic``:
    under ``deterministic_cudnn``; ``fault``: with that fault planted
    (``planted_fault``); ``first_moments``: also the first moments after
    the first micro-step (0.1 of its gradient where it applied an
    update), before the parameters of two runs can part. ``float64``: the
    seeded model, its optimizer and the batch's floating fields in
    float64, and the micro-steps' new tensors too (the default dtype while
    they run): a reference free of float32 rounding, on the CPU, where
    every kernel's plain version runs (the CUDA kernels take float32 and
    bfloat16 only)."""
    if float64 and torch.device(device).type != "cpu":
        raise ValueError("float64 runs on the CPU: the CUDA kernels take "
                         "float32 and bfloat16 only")
    from ..models import MGAR
    from ..parallel.mesh import shard_batch, shard_train_state
    from ..parallel.multihost import reduce_metrics_mean
    from ..train.train_state import TrainState, make_optimizer, make_train_step
    from .testing import (batch_from_numpy, block_frames_,
                          synthetic_batch_numpy, uneven_people_)
    device = torch.device(device)
    if fields is None:
        fields = synthetic_batch_numpy(cfg, **synthetic)
        if frame_blocks:
            block_frames_(fields, frame_blocks, np.random.default_rng(1))
        if people:
            uneven_people_(fields, people)
    if reverse:
        fields = _flip(fields)
    model = MGAR(cfg, device=device,
                 generator=torch.Generator().manual_seed(cfg.train.seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if float64:
        model.double()
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    stage = dataclasses.replace(cfg.train.stages[0], learning_rate=lr)
    opt = make_optimizer(model.parameters(), stage, 8,
                         cfg.train.grad_accum_steps, cfg.train.lr_decay_gamma)
    state = TrainState(model=model, optimizer=opt)
    batch = batch_from_numpy(fields, device=device)
    if float64:
        batch = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name).double()
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)
            and getattr(batch, f.name).is_floating_point()})
    use = None if broken else mesh
    if use is not None:
        state = shard_train_state(state, use)
        batch = shard_batch(batch, use)
    metrics, ms, log, kernels = [], [], [], None
    launch_counts(set_to=dict.fromkeys(launch_counts(), 0))
    with planted_fault(fault), deterministic_cudnn(deterministic), \
            _default_dtype(torch.float64 if float64 else None):
        step = make_train_step(model, state.optimizer, stage.loss,
                               state=state, seed=cfg.train.seed, mesh=use)
        for i in range(steps):
            note_progress(f"micro-step {i}")
            last = i == steps - 1
            with recorded_collectives() as calls:
                if last and check_kernels:
                    box = {}
                    kernels = kernel_checks(
                        lambda: box.update(out=step(batch)))
                    out = box["out"]
                else:
                    out, t = _timed(lambda: step(batch), device)
                    ms.append(t)
            if last:
                log = list(calls)
            metrics.append(reduce_metrics_mean(
                {k: float(v) for k, v in out.items()}) if use is not None
                else {k: float(v) for k, v in out.items()})
            if i == 0 and first_moments:
                first = _cpu(state.optimizer.state_dict()["exp_avg"])
    _sync(device)
    out = {"metrics": metrics, "ms": ms, "collectives": log,
           "kernels": kernels, "launches": launch_counts(),
           "names": [k for k, p in model.named_parameters()
                     if p.requires_grad],
           "held": slice_shapes(state.optimizer),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in state.optimizer.params)}
    if states:
        opt = state.optimizer.state_dict()      # gathered: every rank
        if not full_state:
            opt = {k: opt[k] for k in ("exp_avg", "mini_step", "updates")}
        out.update(model=_cpu(model.state_dict()), optimizer=_cpu(opt))
    if first_moments:
        out["first_exp_avg"] = first
    return out


def det_step(mesh=None, device="cpu", *, name: str, det_cfg,
             in_channels: int, batch, state_dict: dict,
             lr: float = 1e-6, reverse: bool = False,
             deterministic: bool = False,
             fault: Optional[str] = None) -> dict:
    """One ``make_det_train_step`` step of detector ``name`` from
    ``state_dict`` over the global DetBatch ``batch``; with a mesh each
    rank steps on ``shard_det_batch``'s block; ``reverse`` takes the
    batch's samples in the reverse order. Returns the metrics (their
    mean over the ranks), the step's milliseconds and kernel launches,
    the trainable parameters' names, AdamW's first moments (linear in the
    clipped gradient after one step) and the parameters after it. ``deterministic`` and ``fault`` as
    ``mgar_steps``'."""
    from ..detection.detectors import build_detector
    from ..detection.train import (create_det_train_state,
                                   make_det_train_step, shard_det_batch)
    from ..parallel.multihost import reduce_metrics_mean
    device = torch.device(device)
    model = build_detector(name, det_cfg, in_channels=in_channels,
                           device=device,
                           generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict)
    st = create_det_train_state(model, learning_rate=lr)
    batch = batch.to(device)
    if reverse:
        batch = dataclasses.replace(batch, **{
            f.name: _flip(getattr(batch, f.name))
            for f in dataclasses.fields(batch)})
    if mesh is not None:
        batch = shard_det_batch(batch, mesh)
    launch_counts(set_to=dict.fromkeys(launch_counts(), 0))
    with planted_fault(fault), deterministic_cudnn(deterministic):
        step = make_det_train_step(model, st, mesh=mesh)
        out, ms = _timed(lambda: step(batch), device)
    launches = launch_counts()
    metrics = {k: float(v) for k, v in out.items()}
    if mesh is not None:
        metrics = reduce_metrics_mean(metrics)
    return {"metrics": metrics, "ms": ms, "launches": launches,
            "names": [k for k, p in model.named_parameters()
                      if p.requires_grad],
            "exp_avg": [_cpu(st.optimizer.state[p]["exp_avg"])
                        for p in st.params],
            "model": _cpu(model.state_dict())}


def checkpoint_roundtrip(mesh=None, device="cpu", *, cfg, source: str,
                         target: str, lr: float = 1e-6) -> dict:
    """MGAR(cfg) and its optimizer at ``lr`` (sharded with a mesh) restored
    from the checkpoint directory ``source`` (train/checkpoint.py), then
    saved to ``target`` (process 0 writes). Returns the step and the names
    of the tensors whose restored full state (the optimizer's gathered
    from the ranks) is not bit for bit the source file's. A checkpoint
    holds full tensors, so one written at any mesh shape restores at any
    other."""
    from ..models import MGAR
    from ..parallel.mesh import shard_train_state
    from ..train.checkpoint import CheckpointManager
    from ..train.train_state import TrainState, make_optimizer
    model = MGAR(cfg, device=device,
                 generator=torch.Generator().manual_seed(cfg.train.seed))
    stage = dataclasses.replace(cfg.train.stages[0], learning_rate=lr)
    state = TrainState(model=model, optimizer=make_optimizer(
        model.parameters(), stage, 8, cfg.train.grad_accum_steps,
        cfg.train.lr_decay_gamma))
    if mesh is not None:
        state = shard_train_state(state, mesh)
    ckpt = CheckpointManager(source)
    ckpt.restore(state)
    saved = torch.load(os.path.join(source, f"step_{ckpt.latest_step()}.pt"),
                       map_location="cpu", weights_only=True)
    differ = different_tensors(
        {"model": _cpu(model.state_dict()),
         "optimizer": _cpu(state.optimizer.state_dict())},
        {"model": saved["model"], "optimizer": saved["optimizer"]})
    CheckpointManager(target).save(
        state.step, state, write=mesh is None or dist.get_rank() == 0)
    return {"step": state.step, "differ": differ}


def different_tensors(got, ref, path: str = "") -> List[str]:
    """The paths in two trees (dicts, lists, tensors, numbers) where they
    are not equal bit for bit."""
    if isinstance(ref, dict):
        if set(got) != set(ref):
            return [f"{path}: keys"]
        return [p for k in ref for p in different_tensors(
            got[k], ref[k], f"{path}/{k}")]
    if isinstance(ref, (list, tuple)):
        if len(got) != len(ref):
            return [f"{path}: length"]
        return [p for i, (a, b) in enumerate(zip(got, ref))
                for p in different_tensors(a, b, f"{path}/{i}")]
    if isinstance(ref, torch.Tensor):
        return [] if torch.equal(got, ref) else [path]
    return [] if got == ref else [path]


def dropout_masks(mesh=None, device="cpu", *, shape, p: float = 0.2,
                  seed: int = 0) -> torch.Tensor:
    """A training Dropout(p) over ones of the global ``shape`` from a
    generator seeded ``seed``: the whole output without a mesh, the rank's
    block of rows with one (``attach``)."""
    from ..models.layers import Dropout
    from ..parallel.mesh import attach, axis_rank, axis_size
    layer = Dropout(p).train()
    layer.generator = torch.Generator(device=device).manual_seed(seed)
    x = torch.ones(shape, device=device)
    if mesh is not None:
        holder = torch.nn.Sequential(layer)
        attach(holder, mesh)
        b = shape[0] // axis_size(mesh, "data")
        r = axis_rank(mesh, "data")
        x = x[r * b:(r + 1) * b]
    return layer(x).cpu()


def multihost(mesh=None, device="cpu") -> dict:
    """The multihost functions on rank-dependent inputs: rank r holds r + 1
    rows, metrics {"a": r, "b": 10 r}, records [(r, k) for k <= r]."""
    from ..parallel import multihost as mh
    r = mh.process_index()
    return {"count": mh.process_count(), "index": r,
            "arrays": mh.allgather_arrays(
                {"x": np.full((r + 1, 2), r, np.float32),
                 "y": [np.arange(r + 1)]}),
            "mean": mh.reduce_metrics_mean({"b": 10.0 * r, "a": float(r)}),
            "records": mh.merge_eval_records([(r, k) for k in range(r + 1)])}


CASES = {"mgar_steps": mgar_steps, "det_step": det_step,
         "checkpoint_roundtrip": checkpoint_roundtrip,
         "dropout_masks": dropout_masks, "multihost": multihost}


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
