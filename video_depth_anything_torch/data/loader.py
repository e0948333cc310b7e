"""Host-side batching loader with background prefetch (the port's copy
of the JAX package's ``data/loader.py``): a thread decodes and crops the
next batch while the card runs the current step."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, drop_last: bool = True,
                 num_shards: int = 1, shard_id: int = 0):
        """num_shards/shard_id: multi-host data sharding — every process
        shuffles with the same seed and keeps rows shard_id::num_shards, so
        the union is a disjoint cover of the epoch (parallel/distributed.py
        assembles the global batch from these per-host rows)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        assert 0 <= shard_id < num_shards, (shard_id, num_shards)
        self.num_shards = num_shards
        self.shard_id = shard_id

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.num_shards > 1:
            n = (len(idx) // self.num_shards) * self.num_shards
            idx = idx[self.shard_id:n:self.num_shards]
        return idx

    def _collate(self, items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in batches:
                    q.put(self._collate([self.dataset[int(i)] for i in b]))
            except Exception as e:  # surface loader errors on the main thread
                q.put(e)
            q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item
