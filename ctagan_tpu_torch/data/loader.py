"""Threaded prefetching batch loader of the port (``ctagan_tpu/data/
loader.py::PrefetchLoader``).

Worker threads decode items into a bounded queue of ready numpy batches, in
order, so DICOM reads stay off the training step's critical path. The order
is reshuffled every epoch from ``rng``; ``drop_last`` drops a ragged tail.

``shard=(rank, world)`` is the data-parallel feed (``parallel/mesh.py``):
every rank shuffles with the same seeded ``rng``, cuts the order into
global batches of ``batch_size × world`` and keeps its block of each,
rows ``rank·batch_size … (rank + 1)·batch_size``, the rows device ``rank``
holds when JAX shards the global batch over ``P("data")``; ``len()`` counts
global batches (``drop_last``, which sharding requires). At ``batch_size``
1 a rank's items are ``order[rank::world]``, JAX's multi-process layout.
A rank decodes only its own items; for each of the others' it calls the
dataset's ``skip(index)`` where the dataset has one, so a dataset that
draws at access (``VolumePatchDataset``) keeps its stream in step with one
process's.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_SENTINEL = object()


class _DecodeError:
    """A worker's exception, carried to the consumer."""

    def __init__(self, index, error):
        self.index = index
        self.error = error


def _collate(items) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    paths = {}
    for k in items[0]:
        if k.endswith("_path"):
            paths[k] = [it[k] for it in items]
        else:
            out[k] = np.stack([it[k] for it in items])
    out.update(paths)  # type: ignore[arg-type]
    return out


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_threads: int = 4,
                 prefetch: int = 8, rng: Optional[np.random.Generator] = None,
                 shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.rng = rng or np.random.default_rng(0)
        if shard is not None:
            rank, world = shard
            if not 0 <= rank < world:
                raise ValueError(f"shard {shard}: rank outside the world")
            if not drop_last:
                raise ValueError("a sharded loader drops the ragged tail "
                                 "(drop_last=True)")
        self.shard = shard

    def _global_batch(self) -> int:
        return self.batch_size * (self.shard[1] if self.shard else 1)

    def __len__(self) -> int:
        n, g = len(self.dataset), self._global_batch()
        if self.drop_last:
            return n // g
        return (n + g - 1) // g

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        g, bs = self._global_batch(), self.batch_size
        rank = self.shard[0] if self.shard else 0
        skip = getattr(self.dataset, "skip", None)
        results: Dict[tuple, object] = {}
        failed: list = []  # a skip's error
        lock = threading.Lock()
        ready = threading.Condition(lock)
        done = threading.Event()
        todo: "queue.Queue" = queue.Queue()
        # (batch, row in this rank's block or -1 for another rank's, item),
        # in global order, so a dataset's draws at access come in one
        # process's order
        batches = []
        for bi in range(len(self)):
            idxs = order[bi * g:(bi + 1) * g]
            mine = range(rank * bs, rank * bs + bs) if self.shard else range(
                len(idxs))
            batches.append(len(mine))
            for j, di in enumerate(idxs):
                if j in mine:
                    todo.put((bi, j - mine.start, int(di)))
                elif skip is not None:
                    todo.put((bi, -1, int(di)))

        def worker():
            while not done.is_set():
                try:
                    bi, j, di = todo.get_nowait()
                except queue.Empty:
                    return
                try:
                    if j < 0:
                        skip(di)
                        continue
                    item = self.dataset[di]
                except Exception as e:  # surface decode errors, never hang
                    item = _DecodeError(di, e)
                with ready:
                    if j < 0:
                        failed.append(item)
                    else:
                        results[(bi, j)] = item
                    ready.notify_all()

        out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def put(obj) -> bool:
            while True:  # a bounded put that honours abandonment
                try:
                    out.put(obj, timeout=0.1)
                    return True
                except queue.Full:
                    if done.is_set():
                        return False

        def collator():
            try:
                for bi, rows in enumerate(batches):
                    items = []
                    with ready:
                        for j in range(rows):
                            while (bi, j) not in results and not failed:
                                if done.is_set():
                                    return
                                ready.wait(0.1)
                            if failed:
                                break
                            items.append(results.pop((bi, j)))
                    err = next((it for it in failed + items
                                if isinstance(it, _DecodeError)), None)
                    if not put(err if err is not None else _collate(items)):
                        return
                    if err is not None:
                        return
            finally:
                put(_SENTINEL)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        threads.append(threading.Thread(target=collator, daemon=True))
        for t in threads:
            t.start()
        try:
            while True:
                batch = out.get()
                if batch is _SENTINEL:
                    break
                if isinstance(batch, _DecodeError):
                    raise RuntimeError(
                        f"failed to decode dataset item {batch.index}"
                    ) from batch.error
                yield batch
        finally:
            done.set()
