"""Dataset types (counterpart of ``paddle_tpu/io/dataset.py``): a copy of
the reference's, with ``random_split`` taking its seed explicitly."""

from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        n = len(tensors[0])
        if any(len(t) != n for t in tensors):
            raise ValueError("tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = datasets
        n = len(datasets[0])
        if any(len(d) != n for d in datasets):
            raise ValueError("datasets must have the same length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets: List[IterableDataset]):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        i = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx - (self.cumulative_sizes[i - 1] if i > 0 else 0)
        return self.datasets[i][off]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None, *, seed: int):
    """Split ``dataset`` into ``Subset``s of ``lengths`` (counts, or
    fractions summing to 1) over the permutation of numpy's
    ``RandomState(seed)``: the reference's split for the same seed."""
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(n, float) for n in lengths) and abs(
            sum(lengths) - 1.0) < 1e-6:
        counts = [int(total * n) for n in lengths]
        counts[-1] = total - sum(counts[:-1])
        lengths = counts
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset size")
    perm = np.random.RandomState(int(seed)).permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out
