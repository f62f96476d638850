"""Datasets (``repro.core.data.dataset``), numpy only: a sample is an
array or a tuple of arrays; datasets compose into batch / shuffle /
prefetch pipelines.  A copy of the reference's framework-free module,
so the port imports nothing of ``repro``."""

from __future__ import annotations

import abc
import queue
import threading
from typing import Any, Sequence

import numpy as np


class Dataset(abc.ABC):
    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def __getitem__(self, idx: int) -> Any: ...

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class TensorDataset(Dataset):
    """Wraps a list of equal-length arrays; sample i is a tuple of rows."""

    def __init__(self, tensors: Sequence[np.ndarray]):
        self.tensors = [np.asarray(t) for t in tensors]
        n = len(self.tensors[0])
        if any(len(t) != n for t in self.tensors):
            raise ValueError("TensorDataset: arrays of unequal length")

    def __len__(self):
        return len(self.tensors[0])

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)


class BatchDataset(Dataset):
    """Batches an underlying dataset."""

    def __init__(self, dataset: Dataset, batch_size: int,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __getitem__(self, idx):
        start = idx * self.batch_size
        stop = min(start + self.batch_size, len(self.dataset))
        samples = [self.dataset[i] for i in range(start, stop)]
        first = samples[0]
        if isinstance(first, tuple):
            return tuple(np.stack([s[j] for s in samples])
                         for j in range(len(first)))
        return np.stack(samples)


class ShuffleDataset(Dataset):
    """Deterministic reshuffle per epoch via ``reshuffle(epoch)``."""

    def __init__(self, dataset: Dataset, seed: int = 0):
        self.dataset, self.seed = dataset, seed
        self._perm = np.random.default_rng(seed).permutation(len(dataset))

    def reshuffle(self, epoch: int) -> None:
        self._perm = np.random.default_rng(
            self.seed + epoch).permutation(len(self.dataset))

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[int(self._perm[idx])]


class PrefetchDataset(Dataset):
    """Background-thread prefetch, in order.  Unlike the reference, the
    worker threads end with the iteration, also when the consumer stops
    early: closing the iterator stops them and joins them."""

    def __init__(self, dataset: Dataset, buffer_size: int = 4,
                 num_threads: int = 2):
        self.dataset = dataset
        self.buffer_size = buffer_size
        self.num_threads = num_threads

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx]

    def __iter__(self):
        n = len(self.dataset)
        out_q: "queue.Queue[tuple[int, Any]]" = queue.Queue(self.buffer_size)
        idx_q: "queue.Queue[int]" = queue.Queue()
        for i in range(n):
            idx_q.put(i)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i = idx_q.get_nowait()
                except queue.Empty:
                    return
                item = (i, self.dataset[i])
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        pending: dict[int, Any] = {}
        try:
            for nxt in range(n):
                while nxt not in pending:
                    i, s = out_q.get()
                    pending[i] = s
                yield pending.pop(nxt)
        finally:
            stop.set()
            for t in threads:
                t.join()
