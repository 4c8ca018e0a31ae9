"""Host-side input pipeline (own copy of aanet_tpu/data/pipeline.py:21-133,
for one process): epoch-seeded shuffling, samples decoded and augmented by
a thread pool, batches prefetched on a background thread. Batches are
dicts of numpy arrays; the trainer turns them into torch tensors.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np


def _collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class _Prefetcher:
    """Iterate batches on a background thread with a bounded queue."""

    def __init__(self, gen, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = object()
        self.err: Optional[BaseException] = None

        def worker():
            try:
                for item in gen:
                    self.q.put(item)
            except BaseException as e:  # handed to the consumer
                self.err = e
            finally:
                self.q.put(self.done)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self.done:
                if self.err is not None:
                    raise self.err
                return
            yield item


def _batches(dataset, indices, batch_size, num_workers, seed, drop_last) -> Iterator[Dict[str, np.ndarray]]:
    n = len(indices)
    usable = (n // batch_size) * batch_size if drop_last else n
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for start in range(0, usable, batch_size):
            chunk = indices[start: start + batch_size]
            rngs = [np.random.default_rng((seed, int(i))) for i in chunk]
            yield _collate(list(pool.map(dataset.load, chunk, rngs)))


def make_train_loader(dataset, batch_size: int, epoch: int, seed: int = 326,
                      num_workers: int = 8, prefetch: int = 2):
    """Shuffled, drop-last train batches for one epoch; the order and each
    sample's augmentation are seeded by (seed, epoch)."""
    order = np.random.default_rng((seed, epoch)).permutation(len(dataset))
    gen = _batches(dataset, order, batch_size, num_workers, seed=seed * 1000 + epoch, drop_last=True)
    return _Prefetcher(gen, depth=prefetch)


def make_val_loader(dataset, batch_size: int, num_workers: int = 8, prefetch: int = 2):
    """Sequential validation batches (no shuffle, the remainder kept)."""
    indices = np.arange(len(dataset))
    gen = _batches(dataset, indices, batch_size, num_workers, seed=0, drop_last=False)
    return _Prefetcher(gen, depth=prefetch)
