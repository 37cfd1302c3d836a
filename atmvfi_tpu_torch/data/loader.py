"""Host-side input pipeline: a threaded prefetching batch loader
(`atmvfi_tpu/data/loader.py`).

Worker threads decode and augment items and collate them into stacked
numpy NHWC batches; the consumer takes the batches in order. The batch
order is the JAX loader's (`np.random.default_rng(seed + epoch)`
shuffle). The workers share the dataset's `random.Random`, so items are
reproducible with `num_workers=1` only, as in the JAX package.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


def _collate(samples: Sequence) -> tuple:
    return tuple(np.stack([s[i] for s in samples], axis=0)
                 for i in range(len(samples[0])))


class DataLoader:
    """Iterate batches of a dataset with background decode threads."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> list:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[tuple]:
        batches = self._batches()
        self._epoch += 1
        tasks: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            tasks.put((bi, b))
        results = {}
        ready = threading.Condition()
        # bound the in-flight backlog so workers don't race ahead
        budget = threading.Semaphore(self.prefetch + self.num_workers)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                budget.acquire()
                try:
                    bi, b = tasks.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    batch = _collate([self.dataset[int(i)] for i in b])
                except Exception as e:  # surfaced to the consumer
                    batch = e
                with ready:
                    results[bi] = batch
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with ready:
                    while bi not in results:
                        ready.wait()
                    batch = results.pop(bi)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
                budget.release()
        finally:  # an early break: let the workers drain and end
            stop.set()
            for _ in threads:
                budget.release()
