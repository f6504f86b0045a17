"""Batched input pipeline: sharded sampling + background prefetch.

In place of torch DataLoader(num_workers=4, collate_fn=...) (reference
train_func.py:505-507) and the dormant epoch-seeded DistributedSampler
(pcdet datasets/__init__.py:31-51): each host process deterministically
takes every ``shard_count``-th batch, shuffling is seeded per epoch, and a
background thread overlaps host decode with device compute. Same
constructor, order and padding as multimodal_gar_tpu/data/pipeline.py; the
batches are CPU torch tensors. With ``num_workers > 0`` the samples are
decoded in that many worker processes (data/decode_pool.py), which return
numpy samples in the serial path's order; ``collate`` to torch stays in the
parent, and the workers never touch CUDA. Unlike the JAX package's
pipeline, whose producer thread dies with a decode error and ends the epoch
early, an error in the producer or in a worker is raised to the consumer.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..types import Batch
from .jrdb import JRDBActDataset, collate


class DataPipeline:
    def __init__(self, dataset: JRDBActDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 2023,
                 shard_index: int = 0, shard_count: int = 1,
                 drop_last: bool = True, prefetch: int = 2,
                 with_eig: bool = False, eig_max_vecs: int = 16,
                 num_workers: int = 0, mp_context: str = "fork"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.drop_last = drop_last
        self.prefetch = prefetch
        # precompute spectral-loss eigvecs in the producer thread instead of
        # synchronously in the step loop (reference-free; SURVEY.md §7.2.4)
        self.with_eig = with_eig
        self.eig_max_vecs = eig_max_vecs
        # num_workers > 0: decode in OS processes (reference DataLoader
        # num_workers=4, train_func.py:505-507); the thread producer is
        # GIL-capped at ~1 core of decode
        self.num_workers = num_workers
        self.mp_context = mp_context
        self._pool = None
        if num_workers > 0:
            # fork workers EAGERLY from the constructing (usually main)
            # thread: the fewer live threads at fork time, the fewer
            # runtime locks a child can inherit in a held state. Callers
            # build their pipelines before anything initialises CUDA
            # (train/loop.py), so the workers start clear of the card.
            self._get_pool()

    def _get_pool(self):
        if self._pool is None:
            from .decode_pool import ProcessDecodePool
            self._pool = ProcessDecodePool(self.dataset, self.num_workers,
                                           mp_context=self.mp_context)
        return self._pool

    def close(self) -> None:
        """Shut down decode workers (no-op for the serial/thread path)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def _make_batch(self, indices, samples=None) -> Batch:
        """Collate one batch; short batches are PADDED to batch_size with
        all-invalid duplicates so every step sees one shape."""
        indices = [int(i) for i in indices]
        pad = self.batch_size - len(indices)
        if samples is None:
            samples = [self.dataset[i] for i in indices]
        samples = list(samples) + [samples[-1]] * pad
        batch = collate(samples)
        if pad:
            pv = batch.person_valid.clone()
            pv[len(indices):] = False
            batch = dataclasses.replace(batch, person_valid=pv)
        if self.with_eig:
            from ..train.losses import prepare_eig_inputs
            e_hat, e_count = prepare_eig_inputs(
                batch.social_group_id.numpy(), batch.person_valid.numpy(),
                self.eig_max_vecs)
            batch = dataclasses.replace(batch, e_hat=torch.from_numpy(e_hat),
                                        e_count=torch.from_numpy(e_count))
        return batch

    def steps_per_epoch(self) -> int:
        n_batches = len(self.dataset) // self.batch_size if self.drop_last \
            else -(-len(self.dataset) // self.batch_size)
        return max(n_batches // max(self.shard_count, 1), 1)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # epoch-seeded deterministic shuffle (DistributedSampler semantics)
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Yield collated batches for one epoch (this shard's slice)."""
        if hasattr(self.dataset, "set_epoch"):
            # per-(epoch, index) augmentation RNG: keeps the serial path,
            # the decode pool, and resumed runs byte-identical
            self.dataset.set_epoch(epoch)
        order = self._epoch_order(epoch)
        n_full = len(order) // self.batch_size
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_full)]
        if not self.drop_last and len(order) % self.batch_size:
            batches.append(order[n_full * self.batch_size:])
        # with drop_last (training) every shard must yield the SAME number
        # of batches: processes that run the train step in lockstep (a
        # gradient all-reduce) would hang on an unequal strided split.
        # Truncate to a multiple of shard_count before sharding. Without it
        # (evaluation, whose processes run no collective per batch) the
        # shards keep every batch, so their lengths may differ by one; the
        # JAX package's pipeline truncates there too.
        if self.shard_count > 1 and self.drop_last:
            n_even = (len(batches) // self.shard_count) * self.shard_count
            batches = batches[:max(n_even, 0)]
        my_batches = batches[self.shard_index::self.shard_count]

        def decoded_batches():
            """Yield (indices, samples) pairs — multi-process when
            num_workers>0 (ordering identical to the serial path), else
            decoded inline in the producer thread."""
            if self.num_workers > 0:
                pool = self._get_pool()
                flat = [int(i) for b in my_batches for i in b]
                stream = pool.imap(flat, epoch=epoch)
                try:
                    for b in my_batches:
                        yield b, [next(stream) for _ in range(len(b))]
                finally:
                    stream.close()
            else:
                for b in my_batches:
                    yield b, None

        if self.prefetch <= 0:
            # no producer thread; the decode workers, where there are any,
            # still decode ahead of the consumer
            for b, samples in decoded_batches():
                yield self._make_batch(b, samples)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that honors the stop flag — a plain q.put would
            block forever when the consumer abandons the generator early
            (shape warm-up, max_steps_per_epoch breaks), leaking the
            thread and its queued batches."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b, samples in decoded_batches():
                    if stop.is_set():
                        return
                    if not _put(self._make_batch(b, samples)):
                        return
            except BaseException as exc:
                # a decode error (of this thread or of a worker process)
                # ends the epoch in the consumer, not silently here
                _put(exc)
            finally:
                _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a blocked producer's final put can complete
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # serialize epochs: the abandoned producer must finish its
            # decode-pool teardown (imap close/drain) before the next
            # epoch's producer starts a new imap on the same pool
            t.join(timeout=60.0)
