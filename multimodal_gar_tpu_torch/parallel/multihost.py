"""Cross-process collectives of evaluation and logging
(parallel/multihost.py), over ``torch.distributed``.

pcdet's pickle-based ``all_gather`` (commu_utils.py:50-111), its
``reduce_dict`` (:114-168) and ``merge_results_dist``
(common_utils.py:211-232), as the JAX package has them over
``multihost_utils``. Each function returns its input unchanged where no
process group is initialised or the world is one process. Collective
tensors live on the card for NCCL and on the CPU for gloo.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_arrays(x: Any) -> Any:
    """A tree (dict, list, tuple) of numpy arrays of every process,
    concatenated along axis 0 in rank order; the leaves' first dimensions
    may differ between processes."""
    if not _active():
        return x
    trees: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(trees, x)

    def cat(*leaves):
        if isinstance(leaves[0], dict):
            return {k: cat(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], (list, tuple)):
            return type(leaves[0])(cat(*parts) for parts in zip(*leaves))
        return np.concatenate([np.asarray(a) for a in leaves], axis=0)
    return cat(*trees)


def reduce_metrics_mean(metrics: Dict[str, float]) -> Dict[str, float]:
    """Scalar metrics averaged over the processes: sorted keys, one
    float32 vector, one all-reduce."""
    if not _active():
        return metrics
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float32,
                       device=_device())
    dist.all_reduce(vec)
    vec /= dist.get_world_size()
    return {k: float(v) for k, v in zip(keys, vec.tolist())}


def merge_eval_records(records: List) -> List:
    """The record lists of every process concatenated in rank order.
    Records are any picklable values, exchanged as the JAX package does:
    an all-gather of the byte lengths, then one of the buffers padded to
    the longest."""
    if not _active():
        return records
    world = dist.get_world_size()
    device = _device()
    buf = torch.frombuffer(bytearray(pickle.dumps(records)), dtype=torch.uint8)
    length = torch.tensor([buf.numel()], dtype=torch.int64, device=device)
    lengths = [torch.empty_like(length) for _ in range(world)]
    dist.all_gather(lengths, length)
    lengths = [int(n.item()) for n in lengths]
    padded = torch.zeros(max(lengths), dtype=torch.uint8, device=device)
    padded[:buf.numel()] = buf.to(device)
    bufs = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(bufs, padded)
    merged: List = []
    for b, n in zip(bufs, lengths):
        merged.extend(pickle.loads(b[:n].cpu().numpy().tobytes()))
    return merged
