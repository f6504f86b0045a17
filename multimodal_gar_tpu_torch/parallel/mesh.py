"""The ('data', 'fsdp') mesh over ``torch.distributed`` (parallel/mesh.py).

One process per card and an explicit ``DeviceMesh``. Under GSPMD the JAX
step over a sharded batch is the single-device program: the batch is split
over 'data', every training BatchNorm takes its statistics over the global
batch, every loss divides by counts over the global batch, and the compiler
inserts the gradient reduction. Here each of those is explicit, so that
data parallelism stays a layout and not a change of the math:

- ``shard_batch``: this rank's contiguous block of rows of every leaf, what
  ``P("data")`` gives a device. Ranks that share a data coordinate see the
  same rows: the batch is replicated along 'fsdp'.
- ``attach`` (called by the steps, with None too): binds the model's
  training BatchNorms to the data group (their sums go through an
  autograd-aware all-reduce) and its dropouts to the global batch's masks,
  or, without a mesh, unbinds them.
- ``shard_train_state``: at fsdp > 1 each rank keeps its slice of the
  parameters' master copy and of the optimizer state (``ShardedAdam``).
  The step counter and the BatchNorm running statistics stay
  replicated.
- ``batch_denominator``: what a step passes its losses as their
  ``denominator``: a loss whose count spans the batch divides its local
  numerator by the global count over 'data', over the data size. The mean
  over the ranks of the gradients is then the gradient of the global
  batch's loss.
- ``all_reduce_grads``: the mean of the gradients over 'data', in flat
  buckets, reduce-scattered onto the fsdp slices at fsdp > 1.

The train steps take their gradients with ``torch.autograd.grad``, on which
the hooks of DistributedDataParallel and FSDP never fire; so the steps call
the reduction themselves (train/train_state.py, detection/train.py).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig

# elements per flat bucket of a collective (64 MiB of float32)
BUCKET_NUMEL = 1 << 24


def make_mesh(cfg: MeshConfig, device="cuda"):
    """A ('data', 'fsdp') ``DeviceMesh`` over the initialised process group,
    ``data = -1`` taking every process the fsdp axis leaves."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import init_device_mesh
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    n = dist.get_world_size()
    fsdp = max(cfg.fsdp, 1)
    data = cfg.data if cfg.data > 0 else n // fsdp
    assert data * fsdp == n, f"mesh {data}x{fsdp} != {n} processes"
    return init_device_mesh(device.type, (data, fsdp),
                            mesh_dim_names=("data", "fsdp"))


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_rank(mesh, name: str) -> int:
    return int(mesh.get_local_rank(name))


def mesh_device(mesh) -> torch.device:
    """The device this process's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's block of rows along axis 0 of every leaf of ``batch`` (a
    dataclass, dict, tuple, tensor or numpy array; None stays None), on the
    rank's device: rows ``[r * b, (r + 1) * b)`` with r the data
    coordinate and b = B / data."""
    data, rank = axis_size(mesh, "data"), axis_rank(mesh, "data")
    device = mesh_device(mesh)

    def block(x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            if x.ndim == 0 or x.shape[0] % data:
                raise ValueError(f"a leaf of shape {tuple(x.shape)} does not "
                                 f"split into {data} blocks of rows")
            b = x.shape[0] // data
            return x[rank * b:(rank + 1) * b].to(device)
        if isinstance(x, dict):
            return {k: block(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(block(v) for v in x)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: block(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        raise TypeError(f"shard_batch cannot split a {type(x).__name__}")
    return block(batch)


def split_axis(shape: Sequence[int], fsdp: int) -> Optional[int]:
    """The JAX rule (mesh.py:51-67): the largest axis that ``fsdp``
    divides (the first of equal ones), None (replicated) where none does
    or at fsdp 1."""
    if fsdp == 1 or len(shape) == 0:
        return None
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[ax] % fsdp == 0 and shape[ax] >= fsdp:
            return ax
    return None


def fsdp_param_sharding(params, mesh):
    """For each parameter, the axis it is split on over 'fsdp', or None.
    ``params``: a module (-> {name: axis}), a dict or a sequence of
    tensors or shapes (-> the same structure)."""
    fsdp = axis_size(mesh, "fsdp")

    def axis(p):
        return split_axis(tuple(getattr(p, "shape", p)), fsdp)
    if isinstance(params, torch.nn.Module):
        return {k: axis(p) for k, p in params.named_parameters()}
    if isinstance(params, dict):
        return {k: axis(p) for k, p in params.items()}
    return [axis(p) for p in params]


def attach(model: torch.nn.Module, mesh) -> None:
    """Bind ``model``'s training BatchNorms to the mesh's data group, where
    it has more than one rank, and its dropouts to the global batch's
    masks (each rank draws the global mask and keeps its rows); with no
    mesh (or one data rank), unbind them, so that the model is local."""
    from ..models.layers import BatchNorm, Dropout
    data = 1 if mesh is None else axis_size(mesh, "data")
    group = mesh.get_group("data") if data > 1 else None
    shard = (axis_rank(mesh, "data"), data) if data > 1 else None
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_group = group
        elif isinstance(m, Dropout):
            m.shard = shard


def shard_train_state(state, mesh):
    """``state`` (train/train_state.py: TrainState) on the mesh: at fsdp > 1
    its optimizer replaced by a ``ShardedAdam`` over this rank's slices.
    The model, the step counter and the BatchNorm running statistics stay
    replicated."""
    if axis_size(mesh, "fsdp") > 1 and state.optimizer is not None \
            and not isinstance(state.optimizer, ShardedAdam):
        state = dataclasses.replace(state,
                                    optimizer=ShardedAdam(state.optimizer,
                                                          mesh))
    return state


# -- loss denominators --------------------------------------------------------

def batch_denominator(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``denominator`` a step on ``mesh`` passes its losses (the
    count of a loss that spans the batch -> its divisor). Over a data group
    of W > 1 ranks: the count summed over the group, at least 1, over W,
    so that the mean over the ranks of ``local_sum / denominator`` is the
    global batch's ``sum / count``. Without a mesh or at one data rank:
    the local count, at least 1 (train/loss_lib.py: ``local_count``)."""
    from ..train.loss_lib import local_count
    if mesh is None or axis_size(mesh, "data") == 1:
        return local_count
    group, world = mesh.get_group("data"), axis_size(mesh, "data")

    def denominator(count: torch.Tensor) -> torch.Tensor:
        total = count.detach().clone()
        dist.all_reduce(total, group=group)
        return total.clamp(min=1.0) / world
    return denominator


# -- gradients and parameters -------------------------------------------------

def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[int]]:
    """Indices of ``tensors`` in consecutive groups of at most
    BUCKET_NUMEL elements (a larger tensor alone)."""
    bucket, numel = [], 0
    for i, t in enumerate(tensors):
        if bucket and numel + t.numel() > BUCKET_NUMEL:
            yield bucket
            bucket, numel = [], 0
        bucket.append(i)
        numel += t.numel()
    if bucket:
        yield bucket


def _unflatten(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    sizes = [int(np.prod(s)) for s in shapes]
    return [c.view(s) for c, s in zip(flat.split(sizes), shapes)]


def _quiet(fn, *args, **kwargs):
    # newer torch releases rename the single-tensor collectives and warn
    # on the old names, which every release since 2.0 has
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _all_reduce_mean(tensors: Sequence[torch.Tensor], group,
                     n: int) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        out.extend(_unflatten(flat, [tensors[i].shape for i in idx]))
    return out


def _chunk(t: torch.Tensor, axis: int, n: int, f: int) -> torch.Tensor:
    return t.chunk(n, dim=axis)[f]


def _reduce_scatter_mean(tensors: Sequence[torch.Tensor], axes: Sequence[int],
                         group, n: int, rank: int) -> List[torch.Tensor]:
    """This rank's slices of the mean over the group of ``tensors``."""
    out: List[torch.Tensor] = []
    for idx in _buckets(tensors):
        flat = torch.cat([_chunk(tensors[i], axes[i], n, f).reshape(-1)
                          for f in range(n) for i in idx])
        mine = flat.new_empty(flat.numel() // n)
        _quiet(dist.reduce_scatter_tensor, mine, flat, group=group)
        mine /= n
        out.extend(_unflatten(mine, [_chunk(tensors[i], axes[i], n,
                                            rank).shape for i in idx]))
    return out


def _all_gather_full(slices: Sequence[torch.Tensor], axes: Sequence[int],
                     group, n: int) -> List[torch.Tensor]:
    """The full tensors whose rank-ordered slices along ``axes`` the
    group's ranks hold."""
    out: List[torch.Tensor] = []
    for idx in _buckets(slices):
        local = torch.cat([slices[i].detach().reshape(-1) for i in idx])
        full = local.new_empty(n * local.numel())
        _quiet(dist.all_gather_into_tensor, full, local, group=group)
        rows = [_unflatten(r, [slices[i].shape for i in idx])
                for r in full.view(n, -1)]
        out.extend(torch.cat([rows[f][j] for f in range(n)], dim=axes[i])
                   for j, i in enumerate(idx))
    return out


def all_reduce_grads(grads: Sequence[torch.Tensor],
                     mesh) -> List[torch.Tensor]:
    """The mean over 'data' of each gradient, in flat buckets; at fsdp > 1
    a split gradient comes back as this rank's slice of that mean
    (reduce-scattered over 'fsdp', whose ranks hold equal gradients of one
    block of rows), a replicated one whole."""
    data, fsdp = axis_size(mesh, "data"), axis_size(mesh, "fsdp")
    data_group = mesh.get_group("data")
    grads = list(grads)
    if fsdp == 1:
        return _all_reduce_mean(grads, data_group, data)
    axes = [split_axis(g.shape, fsdp) for g in grads]
    split = [i for i, ax in enumerate(axes) if ax is not None]
    whole = [i for i, ax in enumerate(axes) if ax is None]
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for i, g in zip(whole, _all_reduce_mean([grads[i] for i in whole],
                                            data_group, data)):
        out[i] = g
    slices = _reduce_scatter_mean([grads[i] for i in split],
                                  [axes[i] for i in split],
                                  mesh.get_group("fsdp"), fsdp,
                                  axis_rank(mesh, "fsdp"))
    for i, s in zip(split, _all_reduce_mean(slices, data_group, data)):
        out[i] = s
    return out


def agree_finite(finite: torch.Tensor, mesh) -> torch.Tensor:
    """``finite`` (this rank's all-finite flag over its reduced gradients)
    and-ed over 'fsdp', whose ranks hold different slices; over 'data' the
    reduced gradients, and so the flags, are equal already."""
    if axis_size(mesh, "fsdp") == 1:
        return finite
    flag = finite.to(torch.float32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.get_group("fsdp"))
    return flag[0] > 0


class ShardedAdam:
    """``AccumulatingAdam`` (train/train_state.py) over this rank's fsdp
    slices: the master copy of every split parameter, its accumulator and
    its Adam moments hold the rank's slice on the parameter's
    ``split_axis``; replicated parameters are held whole, as in the JAX
    package's ``shard_train_state``.

    ``params`` stays the module's full parameters, which the step
    differentiates; ``update`` takes the rank's slices of the reduced
    gradients (``all_reduce_grads``) and, after an applied update,
    all-gathers the slices into the full parameters before the next
    forward. ``state_dict`` gathers full tensors (every rank must call
    it), so a checkpoint reads the same at every mesh shape."""

    def __init__(self, optimizer, mesh):
        from ..train.train_state import AccumulatingAdam
        self.params: List[torch.nn.Parameter] = list(optimizer.params)
        self.n = axis_size(mesh, "fsdp")
        self.rank = axis_rank(mesh, "fsdp")
        self.group = mesh.get_group("fsdp")
        self.axes = [split_axis(p.shape, self.n) for p in self.params]
        self.master = [torch.nn.Parameter(self._slice(p.detach(), ax).clone())
                       for p, ax in zip(self.params, self.axes)]
        self.inner = AccumulatingAdam(
            self.master, optimizer.base_lr,
            optimizer.transition * optimizer.k, optimizer.k, optimizer.gamma)
        self.inner.load_state_dict(self._sliced(optimizer.state_dict()))

    def _slice(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        return t if axis is None else _chunk(t, axis, self.n, self.rank)

    def _sliced(self, state: dict) -> dict:
        out = dict(state)
        for key in ("exp_avg", "exp_avg_sq", "acc"):
            out[key] = [self._slice(t, ax)
                        for t, ax in zip(state[key], self.axes)]
        return out

    def _full(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        split = [i for i, ax in enumerate(self.axes) if ax is not None]
        out = [t.detach().clone() for t in tensors]
        gathered = _all_gather_full([tensors[i] for i in split],
                                    [self.axes[i] for i in split],
                                    self.group, self.n)
        for i, t in zip(split, gathered):
            out[i] = t
        return out

    @property
    def learning_rate(self) -> float:
        return self.inner.learning_rate

    @property
    def updates(self) -> int:
        return self.inner.updates

    @property
    def mini_step(self) -> int:
        return self.inner.mini_step

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Accumulate one micro-step of slices; True when it applied an
        update (and gathered the parameters)."""
        applied = self.inner.update(grads)
        if applied:
            with torch.no_grad():
                for p, full in zip(self.params, self._full(self.master)):
                    p.copy_(full)
        return applied

    def state_dict(self) -> dict:
        """``AccumulatingAdam.state_dict`` with full tensors."""
        state = self.inner.state_dict()
        for key in ("exp_avg", "exp_avg_sq", "acc"):
            state[key] = self._full(state[key])
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore full tensors; the master slices are taken anew from the
        parameters, which the caller has loaded first."""
        with torch.no_grad():
            for m, p, ax in zip(self.master, self.params, self.axes):
                m.copy_(self._slice(p.detach(), ax))
        self.inner.load_state_dict(self._sliced(state))
