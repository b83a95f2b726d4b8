"""Counterpart of unet_tpu/data/loader.py, the same host code (the port keeps
its own copy): numpy batches, which train.trainer.upload puts on the card
from pinned memory.

Batch loader: shuffled / weighted-sampled NHWC batches with background
prefetch.

Replaces torch DataLoader + WeightedRandomSampler (reference
src/data/dataloader.py:12-178, tools/train.py:254-273) with a thread-prefetch
iterator producing device-ready numpy batches; the engine/trainer overlaps
host loading with device steps via async dispatch.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 weights: Optional[np.ndarray] = None, drop_last: bool = False,
                 seed: int = 0, prefetch: int = 2, with_indices: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weights = weights
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.with_indices = with_indices

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.weights is not None:
            # sampling with replacement, like torch WeightedRandomSampler
            return self.rng.choice(n, size=n, replace=True, p=self.weights)
        idx = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            imgs, masks = zip(*(self.dataset[int(i)] for i in chunk))
            if self.with_indices:
                yield chunk.copy(), np.stack(imgs), np.stack(masks)
            else:
                yield np.stack(imgs), np.stack(masks)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def make_train_val_loaders(train_ds, val_ds, batch_size: int,
                           oversample_defects: bool = False,
                           defect_boost: float = 2.0, seed: int = 0):
    """Factory mirroring DataLoaderFactory train/val construction
    (reference src/data/dataloader.py:12-178) with the defect oversampling
    option of tools/train.py."""
    weights = None
    if oversample_defects and hasattr(train_ds, "sample_weights"):
        weights = train_ds.sample_weights(boost=defect_boost)
    train = Loader(train_ds, batch_size, shuffle=True, weights=weights,
                   drop_last=True, seed=seed)
    val = Loader(val_ds, batch_size, shuffle=False, prefetch=1)
    return train, val
