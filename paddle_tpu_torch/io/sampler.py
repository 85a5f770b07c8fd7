"""Samplers (counterpart of ``paddle_tpu/io/sampler.py``).

The reference's samplers draw from numpy's ``RandomState`` seeded with the
framework's global seed; the port has no global seed, so each random
sampler takes ``seed`` explicitly and draws the same numbers for it:
``RandomSampler`` permutes with ``RandomState((seed + epoch) % 2**31)``,
the epoch counting its iterations from 0.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np


def _need_seed(seed: Optional[int], who: str) -> int:
    if seed is None:
        raise ValueError(f"{who} draws from numpy's RandomState: pass "
                         f"seed= (the port has no global seed)")
    return int(seed)


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None, *, seed: Optional[int] = None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        self.seed = _need_seed(seed, "RandomSampler")
        self._epoch = 0

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState((self.seed + self._epoch) % (2 ** 31))
        self._epoch += 1
        if self.replacement:
            yield from rng.randint(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None, *,
                 seed: Optional[int] = None):
        super().__init__(None)
        self.indices = list(indices)
        self.seed = _need_seed(seed, "SubsetRandomSampler")

    def __iter__(self):
        rng = np.random.RandomState(self.seed % (2 ** 31))
        for i in rng.permutation(len(self.indices)):
            yield self.indices[i]

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True, *,
                 seed: Optional[int] = None):
        super().__init__(None)
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement
        self.seed = _need_seed(seed, "WeightedRandomSampler")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.RandomState(self.seed % (2 ** 31))
        yield from rng.choice(len(self.weights), size=self.num_samples,
                              replace=self.replacement, p=p).tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Batches of ``batch_size`` indices from ``sampler``, else from a
    ``RandomSampler(dataset, seed=seed)`` when ``shuffle`` or the dataset's
    order."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, *,
                 seed: Optional[int] = None):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, seed=seed)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank ``rank``'s batches of ``num_replicas`` (by default the
    distributed runtime's rank and world size,
    ``paddle_tpu_torch.distributed.get_rank`` / ``get_world_size``): the
    padded index list dealt out round robin, shuffled per ``set_epoch``
    with ``RandomState(seed + epoch)``."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False, *,
                 seed: Optional[int] = None):
        from ..distributed.parallel import get_rank, get_world_size
        if num_replicas is None:
            num_replicas = get_world_size()
        if rank is None:
            rank = get_rank()
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = _need_seed(seed, "DistributedBatchSampler") \
            if shuffle else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % (2 ** 31))
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
