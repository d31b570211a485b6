"""Batching loader, the DistributedSampler + DataLoader analog (numpy only).

Each epoch shuffles the sample indices (seeded by ``seed + epoch``, the
same on every process), pads them by wrapping to a multiple of
``num_shards`` and gives process ``shard_id`` every ``num_shards``-th
index from its own: disjoint shards of equal length (the reference's
DistributedSampler, reference train.py:377-384, as the JAX package's
``ShardedLoader`` has it). One shard is the whole index space in the
epoch's order. Samples are built by worker threads and stacked into
nested dicts of numpy arrays.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Any, Iterator

import numpy as np


def _stack_samples(samples: list[dict[str, Any]]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    first = samples[0]
    for key, value in first.items():
        if isinstance(value, dict):
            out[key] = _stack_samples([s[key] for s in samples])
        elif isinstance(value, str):
            out[key] = [s[key] for s in samples]  # metadata stays a list
        elif isinstance(value, np.ndarray) or np.isscalar(value):
            out[key] = np.stack([np.asarray(s[key]) for s in samples])
        else:
            out[key] = [s[key] for s in samples]
    return out


class ShardedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_shards: int = 1,
        shard_id: int = 0,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _shard_indices(self) -> np.ndarray:
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(indices)
        total = -(-n // self.num_shards) * self.num_shards
        if total > n:
            indices = np.concatenate([indices, indices[: total - n]])
        return indices[self.shard_id :: self.num_shards]

    def __len__(self) -> int:
        """Batches per epoch in this process's shard."""
        per_shard = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        indices = self._shard_indices()
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(len(self))
        ]

        def build(batch_idx):
            return _stack_samples([self.dataset[int(i)] for i in batch_idx])

        if self.num_workers <= 0:
            for batch_idx in batches:
                yield build(batch_idx)
            return

        # Keep num_workers batches in flight ahead of the consumer.
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque(
                pool.submit(build, b) for b in batches[: self.num_workers]
            )
            for nxt in batches[self.num_workers :] + [None] * len(pending):
                yield pending.popleft().result()
                if nxt is not None:
                    pending.append(pool.submit(build, nxt))
