"""Host data pipeline: dict collation and a threaded, prefetching loader.

Port of dram_tpu/data/pipeline.py (`merge_dict`, `collate_dict`,
`DataLoader`, :20-111): samples are loaded and transformed on host
threads while the card computes, and batches are stacked into numpy
arrays ready for one host-to-device copy. With `row_range` (lo, hi)
each index batch is cut to its rows [lo, hi): a rank of a data-parallel
run loads only its share of the global batch, while the identically
seeded sampler keeps the global index sequence the same on every rank.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def merge_dict(list_dict):
    return {k: tuple(d[k] for d in list_dict) for k in list_dict[0].keys()}


def collate_dict(batch):
    """Stack the array values, tuple-merge nested (meta) dicts, list
    everything else."""
    merged = {}
    for k in batch[0].keys():
        if isinstance(batch[0][k], dict):
            merged[k] = merge_dict([b[k] for b in batch])
        elif isinstance(batch[0][k], np.ndarray):
            merged[k] = np.stack([b[k] for b in batch], axis=0)
        else:
            merged[k] = [b[k] for b in batch]
    return merged


class DataLoader:
    """Map-style dataset + sampler -> collated batches, in the sampler's
    order. num_workers=0 loads synchronously; otherwise a pool of
    `num_workers` threads loads whole batches, `prefetch` of them in
    flight."""

    def __init__(self, dataset, sampler, batch_size, drop_last=True,
                 num_workers=4, prefetch=2, collate_fn=collate_dict,
                 row_range=None):
        self.row_range = row_range
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.collate_fn = collate_fn

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _index_batches(self):
        idx = list(iter(self.sampler))
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                return
            if self.row_range is not None:
                lo, hi = self.row_range
                b = b[lo:hi]
            yield b

    def _load(self, idxs):
        return self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers <= 0:
            for b in self._index_batches():
                yield self._load(b)
            return

        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = []
                    for b in self._index_batches():
                        pending.append(pool.submit(self._load, b))
                        while len(pending) >= self.prefetch:
                            q.put(pending.pop(0).result())
                    for f in pending:
                        q.put(f.result())
            except Exception as e:  # surface loader errors to the consumer
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
