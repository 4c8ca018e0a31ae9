"""Host-side input pipeline (own copy of aanet_tpu/data/pipeline.py:21-133):
epoch-seeded shuffling, each process's shard of the global batch,
samples decoded and augmented by a thread pool, batches prefetched on a
background thread. Batches are dicts of numpy arrays; the trainer turns
them into torch tensors. The process's index and count default to the
process group's (``aanet_torch.parallel.mesh``), as the JAX loader's come
from ``jax.process_index()``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from aanet_torch.parallel import mesh


def _collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class _Prefetcher:
    """Iterate batches on a background thread with a bounded queue."""

    def __init__(self, gen, depth: int = 2, length: Optional[int] = None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = object()
        self.err: Optional[BaseException] = None
        self.length = length

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

    def __len__(self):
        return self.length

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self.done:
                if self.err is not None:
                    raise self.err
                return
            yield item


def _batches(dataset, indices, batch_size, num_workers, seed, drop_last,
             keep=lambda i: True) -> Iterator[Optional[Dict[str, np.ndarray]]]:
    """Batches of ``indices``; None in place of a batch that ``keep(i)``
    refuses (it is not loaded)."""
    n = len(indices)
    usable = (n // batch_size) * batch_size if drop_last else n
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for i, start in enumerate(range(0, usable, batch_size)):
            if not keep(i):
                yield None
                continue
            chunk = indices[start: start + batch_size]
            rngs = [np.random.default_rng((seed, int(j))) for j in chunk]
            yield _collate(list(pool.map(dataset.load, chunk, rngs)))


def make_train_loader(dataset, global_batch_size: int, epoch: int, seed: int = 326,
                      num_workers: int = 8, process_index: Optional[int] = None,
                      process_count: Optional[int] = None, prefetch: int = 2):
    """Shuffled, drop-last train batches for one epoch, this process's
    shard: the order seeded by (seed, epoch) and padded to a multiple of
    the process count, every ``process_count``-th sample from
    ``process_index`` on, in batches of ``global_batch_size`` /
    ``process_count`` (aanet_tpu/data/pipeline.py:87-120); each sample's
    augmentation is seeded by (seed, epoch, sample)."""
    pi = mesh.rank() if process_index is None else process_index
    pc = mesh.world_size() if process_count is None else process_count
    local = mesh.local_batch_size(global_batch_size, pc)
    order = np.random.default_rng((seed, epoch)).permutation(len(dataset))
    if len(order) % pc:  # every process the same number of samples
        order = np.concatenate([order, order[: pc - len(order) % pc]])
    shard = order[pi::pc]
    gen = _batches(dataset, shard, local, num_workers, seed=seed * 1000 + epoch, drop_last=True)
    return _Prefetcher(gen, depth=prefetch, length=len(shard) // local)


def make_val_loader(dataset, batch_size: int, num_workers: int = 8, prefetch: int = 2,
                    process_index: Optional[int] = None, process_count: Optional[int] = None):
    """Sequential validation batches (no shuffle, the remainder kept); its
    length is the number of batches. Batch i belongs to process i mod
    ``process_count``: the others' batches come as None, unloaded."""
    pi = mesh.rank() if process_index is None else process_index
    pc = mesh.world_size() if process_count is None else process_count
    indices = np.arange(len(dataset))
    gen = _batches(dataset, indices, batch_size, num_workers, seed=0, drop_last=False,
                   keep=lambda i: i % pc == pi)
    return _Prefetcher(gen, depth=prefetch, length=-(-len(dataset) // batch_size))
