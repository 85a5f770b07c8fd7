"""Datasets and data loading (counterpart of ``paddle_tpu/io/``)."""

from .dataloader import (DataLoader, DevicePrefetcher, default_collate_fn,
                         get_worker_info, numpy_collate_fn)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DevicePrefetcher",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
           "get_worker_info", "numpy_collate_fn", "random_split"]
