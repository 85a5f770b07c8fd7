"""DataLoader and DevicePrefetcher (counterpart of
``paddle_tpu/io/dataloader.py``).

``DataLoader`` batches a map-style dataset through its ``BatchSampler``
(or an iterable one in order) and collates with ``collate_fn``;
``num_workers > 0`` fetches a batch's samples on a thread pool, and a
buffer-reader thread keeps ``prefetch_factor`` batches ready. Not ported
(``NotImplementedError``): ``use_process_workers=True`` (the reference's
worker processes with a shared-memory transport). The reference's native
C++ prefetcher, which it picks by itself for a ``TensorDataset`` with the
default collation, is not ported either: every loader here takes the
thread path, with the batch order of its sampler.

``DevicePrefetcher`` stages the next batches on the device while the
consumer runs the current one. On a CUDA device each batch is copied from
a fresh pinned host buffer on a side stream (a host tensor overwritten
after staging does not reach the device copy); before a batch is handed
out the consumer's stream waits for its copies, and every staged tensor
is recorded on the consumer's stream, so the caching allocator never
reuses its memory while the consumer may still read it. With
``FLAGS_telemetry`` on when it is built, it counts ``io_batches_staged``
and times each staging call (the pinned copy and ``stage_fn``, which only
queue the device copies) into ``io_stage_seconds``, as the reference does.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


def get_worker_info():
    """None: thread workers share the process, as the reference's do."""
    return None


def _collate(batch, wrap):
    """One recursive collator for both public collate fns: ``wrap``
    decides what a stacked ndarray leaf becomes (tensor or numpy)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        stacked = torch.stack(batch)
        return stacked if wrap is torch.from_numpy else stacked.numpy()
    if isinstance(sample, np.ndarray):
        return wrap(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return wrap(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return type(sample)(_collate([b[i] for b in batch], wrap)
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _collate([b[k] for b in batch], wrap) for k in sample}
    return list(batch)


def numpy_collate_fn(batch):
    """``default_collate_fn`` with numpy leaves instead of tensors."""
    return _collate(batch, lambda a: a)


def default_collate_fn(batch):
    """Stack samples into batched tensors, keeping tuples, lists and dicts
    (a leaf of another type becomes the list of the samples' values)."""
    return _collate(batch, torch.from_numpy)


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=False, *,
                 seed: Optional[int] = None):
        """``shuffle`` needs ``seed`` (the sampler's numpy seed)."""
        if use_process_workers:
            raise NotImplementedError(
                "DataLoader(use_process_workers=True) (worker processes "
                "with a shared-memory transport) is not ported: use thread "
                "workers (num_workers)")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last, seed=seed)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _iter_batches(self):
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self.num_workers > 0:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            try:
                for indices in self.batch_sampler:
                    samples = list(pool.map(self.dataset.__getitem__,
                                            indices))
                    yield self.collate_fn(samples)
            finally:
                pool.shutdown(wait=False)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if not self.use_buffer_reader:
            yield from self._iter_batches()
            return
        # the buffer reader: keep prefetch_factor batches ready
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        exc = []
        stop = threading.Event()

        def producer():
            try:
                for b in self._iter_batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised on the consumer side
                exc.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # an abandoned iteration (fit's num_iters) stops the reader
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if exc:
            raise exc[0]


# ---------------------------------------------------------- device staging
def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        return fn(torch.from_numpy(obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    vals = getattr(obj, "vals", None)       # a TrainStep's StagedBatch
    if vals is not None:
        _map_tensors(vals, fn)
    return obj


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A fresh pinned copy: the async copy then never reads memory the
    caller may overwrite (``pin_memory()`` returns a pinned tensor
    itself)."""
    return torch.empty_like(t, device="cpu", pin_memory=True).copy_(t)


class DevicePrefetcher:
    """Stage ``depth`` batches ahead on ``device`` (default: the card)
    while the consumer runs the current one.

    ``stage_fn(batch)`` returns the batch's device form (a TrainStep's
    ``stage``); the default copies every tensor or ndarray leaf. On a CUDA
    device the batch's host tensors are first copied into fresh pinned
    buffers, then ``stage_fn`` runs on a side stream (its ``non_blocking``
    copies overlap the consumer's work); each batch's copies end in an
    event that the consumer's stream waits for when the batch is handed
    out (``wait_stream`` for this batch alone), and each staged tensor is
    recorded on that stream."""

    def __init__(self, data, stage_fn: Optional[Callable] = None,
                 depth: int = 2, device: DeviceLike = None):
        self._data = data
        self.device = resolve_device(device)
        self._stage = stage_fn if stage_fn is not None else self._to_device
        self.depth = max(1, int(depth))
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        from .. import observability as obs
        self._telemetry = obs.enabled()
        if self._telemetry:
            r = obs.registry()
            self._m_staged = r.counter(
                "io_batches_staged",
                "batches staged host->device by DevicePrefetcher")
            self._m_stage_s = r.histogram(
                "io_stage_seconds",
                "host wall clock per staging call (the pinned copy and the "
                "queued host->device copies; the copies overlap compute)")
        else:
            self._m_staged = self._m_stage_s = obs.NULL

    def _to_device(self, batch):
        return _map_tensors(batch, lambda t: t.to(self.device,
                                                  non_blocking=True))

    def _stage_one(self, batch):
        if not self._cuda:
            return self._stage(batch), None
        batch = _map_tensors(batch, lambda t: _pinned(t)
                             if t.device.type == "cpu" else t)
        with torch.cuda.stream(self._copy_stream):
            staged = self._stage(batch)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return staged, done

    def _hand_out(self, staged, done):
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)

            def keep(t):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
                return t
            _map_tensors(staged, keep)
        return staged

    def __iter__(self):
        buf = collections.deque()
        it = iter(self._data)
        exhausted = False
        while True:
            while not exhausted and len(buf) < self.depth:
                try:
                    nxt = next(it)
                except StopIteration:
                    exhausted = True
                    continue
                t0 = time.perf_counter() if self._telemetry else 0.0
                buf.append(self._stage_one(nxt))
                if self._telemetry:
                    self._m_stage_s.observe(time.perf_counter() - t0)
                    self._m_staged.inc()
            if not buf:
                return
            yield self._hand_out(*buf.popleft())
