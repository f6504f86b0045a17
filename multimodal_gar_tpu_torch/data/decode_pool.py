"""Multi-process sample decode pool with deterministic ordering.

In place of the reference's process-based DataLoader workers
(``DataLoader(..., num_workers=4)``, reference train_func.py:505-507): the
per-sample decode (jpg decode + pcd load + voxelize + rulebook, reference
dataloader.py:133-198) is CPU-bound and the GIL caps a thread producer at
~1 core, so feeding a card that consumes >1 core's worth of clips/s
requires OS processes. A copy of multimodal_gar_tpu/data/decode_pool.py
(numpy and multiprocessing only), held equal to it by a test.

Design:
- ``num_workers`` child processes each run a plain task loop: pull
  ``(seq, dataset_index)``, compute ``dataset[index]`` (numpy-only — the
  children NEVER touch CUDA, nor torch at all), push ``(seq, sample)``.
- The parent re-sequences results by ``seq`` so the stream of samples is
  byte-identical to the serial path — batch composition, padding and the
  epoch-seeded shuffle (DistributedSampler semantics) are unchanged.
- A bounded in-flight window (default ``2*num_workers``) caps parent-side
  buffering so memory stays O(workers), not O(epoch).

Fork-safety: queues are ``SimpleQueue`` (a locked pipe), NOT ``mp.Queue``.
``mp.Queue.put`` spawns a feeder *thread* on first use; a forked child
that calls ``Thread.start()`` can deadlock on threading-runtime locks
another parent thread held at fork time. SimpleQueue writes synchronously
under a lock — no threads exist in the children at all — and doubles as
natural backpressure. Results additionally carry the imap *generation*:
when a consumer abandons an epoch mid-stream and starts the next one, the
abandoned imap's teardown drain can overlap the new imap on the same pool,
and without the tag the new imap would mistake stale results for its own
(or the drain would steal the new epoch's — both observed as hangs).

Determinism note: worker *assignment* is dynamic (whichever worker is free
takes the next index) but the output *order* is fixed by ``seq``; since
``dataset[i]`` is a pure function of ``(epoch, i)`` (all augmentation RNG
in the dataset is index/epoch-seeded, see data/jrdb.py), dynamic assignment
cannot change any sample's bytes.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Iterable, Iterator, Optional


def _worker_main(dataset, task_q, result_q) -> None:
    """Child-process task loop. numpy-only: must never touch CUDA (a child
    forked from a process that has initialised it cannot use it), and must
    never start threads (see fork-safety note above)."""
    import os
    log = None
    if os.environ.get("MGAR_DECODE_POOL_DEBUG"):
        import tempfile
        log = open(os.path.join(tempfile.gettempdir(),
                                f"decode_worker_{os.getpid()}.log"), "w",
                   buffering=1)
        log.write("alive\n")
    while True:
        item = task_q.get()
        if log:
            log.write(f"task {item!r}\n")
        if item is None:
            return
        gen, seq, idx, epoch = item
        try:
            if epoch is not None and hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)
            sample = dataset[idx]
            if log:
                log.write(f"decoded {idx}\n")
            result_q.put((gen, seq, sample, None))
            if log:
                log.write(f"put {gen}/{seq}\n")
        except BaseException as exc:  # surface decode errors to the parent
            result_q.put((gen, seq, None, f"{type(exc).__name__}: {exc}"))


class ProcessDecodePool:
    """Decode ``dataset[i]`` across worker processes, yielding in order.

    ``mp_context='fork'`` (default) shares the dataset by COW inheritance —
    no pickling of the (potentially large) annotation index per task.
    ``'spawn'`` is available for environments where forking a threaded
    parent is unsafe; it pickles the dataset once per worker at startup.

    Prefer constructing the pool from the main thread before heavy library
    state exists (DataPipeline does this eagerly in ``__init__``): forked
    children inherit whatever locks other threads held at fork time.
    """

    def __init__(self, dataset, num_workers: int,
                 max_inflight: Optional[int] = None,
                 mp_context: str = "fork"):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1 for a process pool")
        ctx = mp.get_context(mp_context)
        self.num_workers = num_workers
        self.max_inflight = max_inflight or 2 * num_workers
        # SimpleQueue: locked pipe, no feeder threads (fork-safety above)
        self._task_q = ctx.SimpleQueue()
        self._result_q = ctx.SimpleQueue()
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(dataset, self._task_q, self._result_q),
                        daemon=True)
            for _ in range(num_workers)
        ]
        for p in self._procs:
            p.start()
        self._closed = False
        # imap generation counter: every imap gets a fresh tag so results
        # from an abandoned previous imap (same pool) are recognizably
        # stale and discarded instead of being mistaken for current seqs
        self._gen = 0

    def _get_result(self, timeout: Optional[float] = None):
        """result_q.get with an optional timeout (SimpleQueue lacks one).
        The parent is the sole reader, so a poll-then-get is race-free."""
        if timeout is not None and not self._result_q._reader.poll(timeout):
            raise TimeoutError("decode pool result timeout")
        return self._result_q.get()

    def imap(self, indices: Iterable[int],
             epoch: Optional[int] = None) -> Iterator:
        """Yield ``dataset[i]`` for each i, in the order given.

        ``epoch`` is forwarded with every task so forked dataset copies
        re-seed their per-sample augmentation RNG (``set_epoch``) in sync
        with the parent."""
        self._gen += 1
        gen = self._gen
        it = iter(enumerate(indices))
        buf = {}
        next_seq = 0
        inflight = 0
        exhausted = False
        try:
            while True:
                # keep the task window full
                while not exhausted and inflight < self.max_inflight:
                    try:
                        seq, idx = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    self._task_q.put((gen, seq, int(idx), epoch))
                    inflight += 1
                if exhausted and inflight == 0 and not buf:
                    return
                # block until the next-in-order sample is available
                while next_seq not in buf:
                    g, seq, sample, err = self._result_q.get()
                    if g != gen:
                        continue  # stale result from an abandoned imap
                    inflight -= 1
                    if err is not None:
                        raise RuntimeError(
                            f"decode worker failed on seq={seq}: {err}")
                    buf[seq] = sample
                yield buf.pop(next_seq)
                next_seq += 1
        finally:
            if exhausted and inflight == 0 and not buf:
                pass  # clean exhaustion — pool stays reusable
            else:
                # consumer abandoned mid-stream: best-effort drain so the
                # pipe buffer doesn't carry stale results forward (a later
                # imap would discard them by gen, but only after reading)
                while inflight > 0:
                    try:
                        g, _, _, _ = self._get_result(timeout=5.0)
                        if g == gen:
                            inflight -= 1
                    except Exception:
                        break

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()

    def __enter__(self) -> "ProcessDecodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
