"""Data loading: sharded iteration-oriented sampling and a threaded,
prefetching loader (port of ``stif_tpu/data/loader.py``).

  * ``DistIterSampler`` of the reference
    (``codes/data/data_sampler.py:12-65``):
    the dataset enlarged x ratio for iteration-oriented training, an
    epoch-seeded permutation, modulo indexing, a rank-strided subsample.
  * ``create_dataloader`` (``codes/data/__init__.py:19-42``): train loaders
    shuffle and drop the last partial batch.

One worker thread loads and collates batches into a bounded queue while
the device runs steps (the JAX loader's ``num_workers`` is accepted there
and unused; it is not an argument here, and the configs' ``n_workers`` is
not read).
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class ShardedIterSampler:
    """Epoch-seeded, enlarged, rank-strided index stream."""

    def __init__(self, n_items: int, ratio: int = 100, world_size: int = 1,
                 rank: int = 0, seed: int = 0):
        self.n_items = n_items
        self.ratio = ratio
        self.world_size = world_size
        self.rank = rank
        self.seed = seed
        self.num_samples = int(math.ceil(n_items * ratio / world_size))
        self.total_size = self.num_samples * world_size

    def global_indices(self, epoch: int) -> np.ndarray:
        """Every rank's indices of ``epoch``, interleaved: rank r takes
        entries r, r + world, ..."""
        g = np.random.default_rng(self.seed + epoch)
        return g.permutation(self.total_size) % self.n_items

    def epoch_indices(self, epoch: int) -> np.ndarray:
        return self.global_indices(epoch)[self.rank::self.world_size]


class DataLoader:
    """Minimal threaded loader: dataset + collate + prefetch queue.

    A dataset with ``use_load_batch`` set is asked for whole batches
    (``dataset.load_batch(indices)``), so that it can make one decision per
    batch (one scale bucket for every sample); otherwise samples are loaded
    one by one and collated. With a sampler of ``world_size`` ranks and
    ``batch_size`` = global batch / world, batch b of the ranks together
    holds the indices of global batch b at world size 1; a rank's batch
    then goes to ``dataset.load_batch(indices, group)``, with ``group`` the
    global batch's indices, so that every rank makes the global batch's
    decision."""

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 sampler: Optional[ShardedIterSampler] = None,
                 drop_last: bool = True,
                 prefetch: int = 4, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.sampler = sampler
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed

    def _index_batches(self, epoch: int):
        """(indices, group) of each batch of ``epoch``."""
        world = 1
        if self.sampler is not None:
            full = self.sampler.global_indices(epoch)
            world = self.sampler.world_size
            idx = full[self.sampler.rank::world]
        else:
            full = idx = np.arange(len(self.dataset))
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(idx)
        bs = self.batch_size
        nb = len(idx) // bs
        rem = len(idx) % bs
        for b in range(nb):
            yield (idx[b * bs:(b + 1) * bs],
                   full[b * bs * world:(b + 1) * bs * world])
        if rem and not self.drop_last:
            yield idx[nb * bs:], full[nb * bs * world:]

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Yield collated batches, loaded by a thread ahead of the
        consumer. Abandoning the generator stops the thread."""
        batches = list(self._index_batches(epoch))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            # a bounded put that re-checks stop: if the consumer abandons
            # the generator the queue stays full, and a bare q.put() would
            # block this thread forever (leaking it and its batches)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        batch_level = getattr(self.dataset, "use_load_batch", False)
        error = []

        def worker():
            try:
                for batch_idx, group in batches:
                    if stop.is_set():
                        break
                    if batch_level:
                        idx = [int(i) for i in batch_idx]
                        group = [int(i) for i in group]
                        batch = (self.dataset.load_batch(idx) if group == idx
                                 else self.dataset.load_batch(idx, group))
                    else:
                        batch = self.collate(
                            [self.dataset[int(i)] for i in batch_idx])
                    if not put_checked(batch):
                        return
            except Exception as e:  # handed to the consumer, raised there
                error.append(e)
            finally:
                put_checked(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            stop.set()
            t.join(timeout=10)

    def __len__(self):
        n = (self.sampler.num_samples if self.sampler is not None
             else len(self.dataset))
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))
