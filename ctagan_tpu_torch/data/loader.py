"""Threaded prefetching batch loader of the port (``ctagan_tpu/data/
loader.py::PrefetchLoader``), without the multi-host ``shard``.

Worker threads decode items into a bounded queue of ready numpy batches, in
order, so DICOM reads stay off the training step's critical path. The order
is reshuffled every epoch from ``rng``; ``drop_last`` drops a ragged tail.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

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
                 prefetch: int = 8, rng: Optional[np.random.Generator] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.rng = rng or np.random.default_rng(0)

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        results: Dict[tuple, object] = {}
        lock = threading.Lock()
        ready = threading.Condition(lock)
        done = threading.Event()
        todo: "queue.Queue" = queue.Queue()
        for bi, idxs in enumerate(batches):
            for j, di in enumerate(idxs):
                todo.put((bi, j, int(di)))

        def worker():
            while not done.is_set():
                try:
                    bi, j, di = todo.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self.dataset[di]
                except Exception as e:  # surface decode errors, never hang
                    item = _DecodeError(di, e)
                with ready:
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
                for bi, idxs in enumerate(batches):
                    items = []
                    with ready:
                        for j in range(len(idxs)):
                            while (bi, j) not in results:
                                if done.is_set():
                                    return
                                ready.wait(0.1)
                            items.append(results.pop((bi, j)))
                    err = next((it for it in items
                                if isinstance(it, _DecodeError)), None)
                    if not put(err if err is not None else _collate(items)):
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
