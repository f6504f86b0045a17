"""Dataset registry: name -> adapter class, plus batch-iterator assembly.

Counterpart of multimodal_gar_tpu/data/registry.py (pcdet's
datasets/__init__.py registry and build_dataloader): ``build_dataset``
resolves an adapter by its config name, and ``det_batches`` yields
fixed-shape DetBatches with the epoch-seeded deterministic sharding that
replaces the reference's DistributedSampler: each process takes
``indices[epoch-shuffled][rank::world]``.

A dataset's ``det_batch`` is the host half, as a DataLoader's collate is:
it reads, voxelizes and builds the rulebook in numpy and returns CPU
tensors. ``det_batches`` is the entry point users call, and moves each
batch to ``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

_DATASETS: Dict[str, str] = {
    # name (as in pcdet DATASET configs) -> "module:Class"
    "KittiDataset": "kitti:KittiDataset",
    "NuScenesDataset": "nuscenes:NuScenesDataset",
    "WaymoDataset": "waymo:WaymoDataset",
    "LyftDataset": "lyft:LyftDataset",
    "ONCEDataset": "once:OnceDataset",
    "PandasetDataset": "pandaset:PandasetDataset",
    "Argo2Dataset": "argo2:Argo2Dataset",
    "CustomDataset": "custom:CustomDataset",
}


def available_datasets() -> Sequence[str]:
    return sorted(_DATASETS)


def build_dataset(name: str, **kwargs):
    """pcdet ``__all__[dataset_cfg.DATASET]`` analogue."""
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {available_datasets()}")
    module_name, cls_name = _DATASETS[name].split(":")
    import importlib
    module = importlib.import_module(f".{module_name}", __package__)
    return getattr(module, cls_name)(**kwargs)


def det_batches(dataset, batch_size: int, voxel_size, max_voxels: int,
                *, shuffle: bool = True, seed: int = 0, epoch: int = 0,
                rank: int = 0, world: int = 1, drop_last: bool = True,
                with_indices: bool = False, device="cuda",
                **det_batch_kwargs) -> Iterator:
    """Deterministic sharded DetBatch iterator over ``dataset``, each batch
    on ``device``.

    The permutation is seeded by (seed, epoch), so every process computes
    the same order, then each rank takes its strided shard. With
    drop_last=False the remainder batch is padded to the fixed batch size
    by repeating the last frame; evaluation loops iterate with
    ``with_indices=True`` (each yield is (real_indices, batch)) and keep
    only the first len(real_indices) per-item outputs.

    The batch comes from ``dataset.det_batch``; ONCE and custom trees have
    none, and are assembled by data/detbatch.py: assemble_det_batch
    (``num_features`` in ``det_batch_kwargs``, 4 by default).
    """
    from ..utils.device import resolve_device
    device = resolve_device(device)
    make = getattr(dataset, "det_batch", None)
    if make is None:
        from .detbatch import assemble_det_batch

        def make(indices, *args, **kwargs):
            return assemble_det_batch(dataset, indices, *args, **kwargs)
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng((seed, epoch)).permutation(n)
    idx = idx[rank::world]
    stop = (len(idx) // batch_size * batch_size) if drop_last else len(idx)
    for s in range(0, stop, batch_size):
        chunk = idx[s:s + batch_size]
        real = list(map(int, chunk))
        if len(chunk) < batch_size and not drop_last:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - len(chunk))])
        batch = make(list(map(int, chunk)), voxel_size, max_voxels,
                     **det_batch_kwargs).to(device)
        yield (real, batch) if with_indices else batch
