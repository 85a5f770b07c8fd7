"""DataLoader and DevicePrefetcher (counterpart of
``paddle_tpu/io/dataloader.py``).

``DataLoader`` batches a map-style dataset through its ``BatchSampler``
(or an iterable one in order) and collates with ``collate_fn``. Three
transports, as in the reference; ``transports`` records which one served
each epoch (``"native"``, ``"thread"`` or ``"process"``):

- native: a loader over an exact ``TensorDataset`` with the default
  collation and ``use_shared_memory`` (no object dtypes) is served by the
  C++ prefetcher of :mod:`..native` (shuffle, gather and queueing off the
  GIL), with the reference's batch order: its splitmix64 shuffle seeded
  ``seed + epoch`` (the reference's ``default_seed() + epoch``; epochs
  count from 1), so the same seed gives the JAX package's batches bit for
  bit. The dataset's tensors (CUDA ones too) are materialized to host
  numpy once; batches are CPU tensors. A failed build of the prefetcher
  raises; only ``PADDLE_TPU_DISABLE_NATIVE=1`` sends such a loader down
  the thread path;
- thread (the default otherwise): ``num_workers > 0`` fetches a batch's
  samples on a thread pool, and a buffer-reader thread keeps
  ``prefetch_factor`` batches ready, in the sampler's order;
- process (``use_process_workers=True`` with ``num_workers > 0``): for a
  GIL-bound ``__getitem__``, forked worker processes each collate whole
  batches (indices in, batch out) and ship ndarray leaves through
  ``multiprocessing.shared_memory`` segments (one copy each side, no
  pickling of array bytes); delivery is reordered to the sampler's order.
  Workers never touch CUDA: a ``TensorDataset`` is materialized to numpy
  in the parent, and the parent wraps each payload with
  ``torch.from_numpy``. Each worker seeds numpy with ``(seed + epoch +
  worker id) % 2**32`` and runs ``worker_init_fn``; ``get_worker_info()``
  is set inside it. A worker's exception re-raises in the parent with its
  traceback; ``timeout`` bounds the accumulated silent time; a worker that
  dies is restarted and every undelivered batch resubmitted (duplicates
  dropped), within ``num_workers * FLAGS_dataloader_max_worker_restarts``
  restarts (``io_worker_restarts`` counts them with ``FLAGS_telemetry``
  on), past which the loader raises ``RuntimeError``. The worker loop
  checks the ``dataloader_worker`` fault site per batch: a fire exits the
  worker (``os._exit(3)``). ``PADDLE_TPU_MP_START=spawn|forkserver``
  overrides the fork start method.

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
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .dataset import Dataset, IterableDataset, TensorDataset
from .sampler import BatchSampler


class _WorkerInfo:
    def __init__(self, id=0, num_workers=0, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info: Optional[_WorkerInfo] = None


def get_worker_info():
    """Inside a process worker, its id, the worker count and its dataset;
    None elsewhere (thread workers share the process, as the reference's
    do)."""
    return _worker_info


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
    """``default_collate_fn`` with numpy leaves instead of tensors (what
    process workers run: batches cross the process boundary as ndarrays
    and become tensors in the parent)."""
    return _collate(batch, lambda a: a)


def default_collate_fn(batch):
    """Stack samples into batched tensors, keeping tuples, lists and dicts
    (a leaf of another type becomes the list of the samples' values)."""
    return _collate(batch, torch.from_numpy)


def _host_array(t) -> np.ndarray:
    """A dataset tensor as host numpy (a CUDA tensor copied once)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ------------------------------------------------------- process workers
# Each worker process owns whole batches (indices in, collated batch out):
# ndarray leaves travel through multiprocessing.shared_memory segments (the
# worker writes once, the parent copies once and unlinks), everything else
# rides the result queue's pickle. A forked worker inherits the dataset.

def _shm_unregister(shm):
    """Ownership of a segment passes to the parent (which unlinks it after
    copying): deregister it from the worker's resource tracker, which
    would unlink it at the worker's exit."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _shm_encode(obj, segs):
    """obj -> a picklable tag tree; ndarray leaves move into shared-memory
    segments (appended to ``segs``). CPU tensors (from a user collate_fn)
    go through numpy and are tagged so the parent restores the type."""
    was_tensor = isinstance(obj, torch.Tensor)
    if was_tensor:
        try:
            obj = obj.detach().numpy()
        except (TypeError, RuntimeError):   # no numpy dtype (bf16): pickle
            return ("obj", obj)
    if isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(create=True,
                                         size=max(1, obj.nbytes))
        np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)[...] = obj
        segs.append(shm)
        return ("nd", shm.name, obj.dtype.str, obj.shape, was_tensor)
    if isinstance(obj, (list, tuple)):
        return ("seq", type(obj) is tuple,
                [_shm_encode(o, segs) for o in obj])
    if isinstance(obj, dict):
        return ("map", {k: _shm_encode(v, segs) for k, v in obj.items()})
    return ("obj", obj)


def _shm_decode(msg, to_tensor):
    tag = msg[0]
    if tag == "nd":
        from multiprocessing import shared_memory
        _, name, dtype, shape, was_tensor = msg
        shm = shared_memory.SharedMemory(name=name)
        try:
            arr = np.ndarray(shape, dtype, buffer=shm.buf).copy()
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        return torch.from_numpy(arr) if (was_tensor or to_tensor) else arr
    if tag == "seq":
        _, is_tuple, items = msg
        out = [_shm_decode(m, to_tensor) for m in items]
        return tuple(out) if is_tuple else out
    if tag == "map":
        return {k: _shm_decode(v, to_tensor) for k, v in msg[1].items()}
    return msg[1]


def _shm_discard(msg):
    """Unlink the segments of a payload that will not be decoded."""
    if msg[0] == "nd":
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(name=msg[1])
            shm.close()
            shm.unlink()
        except Exception:
            pass
    elif msg[0] == "seq":
        for m in msg[2]:
            _shm_discard(m)
    elif msg[0] == "map":
        for m in msg[1].values():
            _shm_discard(m)


def _process_worker_loop(dataset, collate_fn, index_q, result_q, wid,
                         num_workers, worker_init_fn, base_seed):
    global _worker_info
    _worker_info = _WorkerInfo(wid, num_workers, dataset)
    np.random.seed((base_seed + wid) % (2 ** 32))
    torch.set_num_threads(1)    # as PyTorch's own workers: no intra-op pool
    # FLAGS_fault_inject 'dataloader_worker:...': an armed fire makes this
    # worker exit mid-batch, the death the parent's restarts recover from
    # (a clean exception rides result_q and re-raises instead)
    from ..testing import faults as _faults
    _fault = _faults.site("dataloader_worker")
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
        while True:
            item = index_q.get()
            if item is None:
                return
            bidx, indices = item
            try:
                _fault.check(batch=bidx)
            except _faults.InjectedFault:
                # flush the result queue's feeder thread first: exiting
                # while it holds the queue's shared write lock would wedge
                # every surviving worker's put()
                try:
                    result_q.close()
                    result_q.join_thread()
                except Exception:
                    pass
                os._exit(3)
            segs = []
            try:
                batch = collate_fn([dataset[i] for i in indices])
                result_q.put((bidx, "ok", _shm_encode(batch, segs)))
            except Exception as e:      # re-raised in the parent, in order
                import traceback
                for s in segs:          # a partial encode leaks nothing
                    try:
                        s.close()
                        s.unlink()
                    except Exception:
                        pass
                segs = []
                result_q.put((bidx, "err",
                              f"{e!r}\n{traceback.format_exc()[-2000:]}"))
            for s in segs:
                s.close()
                _shm_unregister(s)
    except KeyboardInterrupt:
        pass


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=False, *,
                 seed: Optional[int] = None):
        """``shuffle`` needs ``seed`` (the sampler's numpy seed, and the
        native shuffle's and the workers' base seed)."""
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_buffer_reader = use_buffer_reader
        self.use_process_workers = bool(use_process_workers)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.seed = 0 if seed is None else int(seed)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self._native_arrays: Optional[List[np.ndarray]] = None
        self._native_eligible = False
        self._epoch = 0
        # the transport that served each epoch, in order; the last process
        # epoch's workers as (worker id, exit code, replaced after dying)
        self.transports: List[str] = []
        self.worker_exits: List[tuple] = []
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
            # an exact TensorDataset (a subclass may transform in
            # __getitem__) with the default collation: the native path
            self._native_eligible = (
                use_shared_memory
                and self.collate_fn is default_collate_fn
                and type(dataset) is TensorDataset)
            self._native_cfg = (batch_size, shuffle, drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _native_batches(self):
        """The C++ prefetcher's epoch (see the module docstring); None when
        the loader is not eligible or the opt-out is set. Each call owns
        its prefetcher, destroyed when the generator closes."""
        if not self._native_eligible:
            return None
        from .. import native
        if not native.available():
            return None
        if self._native_arrays is None:
            try:
                arrays = [np.ascontiguousarray(_host_array(t))
                          for t in self.dataset.tensors]
            except (TypeError, RuntimeError):   # no numpy dtype (bf16)
                arrays = None
            if arrays is None or any(a.dtype.hasobject for a in arrays):
                # the C++ gather copies raw bytes: object arrays would
                # smuggle PyObject pointers without references
                self._native_eligible = False
                return None
            self._native_arrays = arrays
        batch_size, shuffle, drop_last = self._native_cfg

        def gen():
            pf = native.BatchPrefetcher(
                self._native_arrays, batch_size=batch_size, shuffle=shuffle,
                drop_last=drop_last, capacity=self.prefetch_factor,
                n_threads=max(self.num_workers, 1))
            try:
                self._epoch += 1
                for bufs in pf.epoch(seed=self.seed + self._epoch):
                    yield tuple(torch.from_numpy(b) for b in bufs)
            finally:
                pf.close()
        return gen()

    def _process_batches(self):
        """The worker-process epoch (see the module docstring); None when
        not asked for (or an iterable dataset, or no workers)."""
        if (not self.use_process_workers or self.num_workers <= 0
                or self._iterable_mode):
            return None
        import multiprocessing as mp
        ctx = mp.get_context(os.environ.get("PADDLE_TPU_MP_START", "fork"))
        n = self.num_workers
        to_tensor = self.collate_fn is default_collate_fn
        collate = numpy_collate_fn if to_tensor else self.collate_fn
        timeout = self.timeout or None
        dataset = self.dataset
        if isinstance(dataset, TensorDataset):
            # materialized here, in the parent: a forked worker never
            # touches CUDA
            dataset = TensorDataset([_host_array(t)
                                     for t in dataset.tensors])

        def gen():
            # a fresh base seed an epoch: the workers' randomness does not
            # repeat across epochs
            self._epoch += 1
            base_seed = self.seed + self._epoch
            index_q = ctx.Queue()
            result_q = ctx.Queue()

            def spawn(wid):
                w = ctx.Process(
                    target=_process_worker_loop,
                    args=(dataset, collate, index_q, result_q, wid,
                          n, self.worker_init_fn, base_seed),
                    daemon=True)
                w.start()
                return w

            workers = [spawn(wid) for wid in range(n)]
            exits = self.worker_exits = []
            from .. import flags as _flags
            from .. import observability as obs
            restart_budget = n * max(0, int(
                _flags.get_flag("dataloader_max_worker_restarts")))
            m_restarts = (obs.registry().counter(
                "io_worker_restarts",
                "process DataLoader workers restarted after dying "
                "mid-epoch") if obs.enabled() else obs.NULL)
            sampler_it = enumerate(iter(self.batch_sampler))
            pending = {}        # bidx -> indices, fed but not delivered
            buffered = {}
            next_yield = 0
            restarts = 0
            # a short poll notices a death promptly; ``timeout`` bounds the
            # accumulated silent time
            poll = min(timeout, 0.25) if timeout else 0.25
            silent = 0.0
            try:
                def feed():
                    item = next(sampler_it, None)
                    if item is not None:
                        bidx, indices = item
                        pending[bidx] = list(indices)
                        index_q.put((bidx, pending[bidx]))

                for _ in range(n * self.prefetch_factor):
                    feed()
                while pending:
                    try:
                        bidx, status, payload = result_q.get(timeout=poll)
                    except queue.Empty:
                        silent += poll
                        dead = [i for i, w in enumerate(workers)
                                if not w.is_alive()]
                        if dead:
                            # which batch died with the worker is unknowable
                            # (the index queue is shared): restart with
                            # backoff and resubmit every undelivered batch;
                            # duplicate deliveries are dropped below
                            if restarts + len(dead) > restart_budget:
                                raise RuntimeError(
                                    f"DataLoader process workers died "
                                    f"{restarts + len(dead)} times (budget"
                                    f" {restart_budget}); giving up: see "
                                    f"FLAGS_dataloader_max_worker_restarts")
                            time.sleep(min(0.05 * (2 ** restarts), 1.0))
                            for i in dead:
                                workers[i].join(timeout=2.0)
                                exits.append((i, workers[i].exitcode, True))
                                workers[i] = spawn(i)
                            restarts += len(dead)
                            m_restarts.inc(len(dead))
                            for bidx2 in sorted(pending):
                                index_q.put((bidx2, pending[bidx2]))
                            silent = 0.0
                            continue
                        if timeout and silent >= timeout:
                            raise RuntimeError(
                                f"DataLoader worker batch timed out "
                                f"after {timeout}s (workers alive; raise "
                                f"timeout or speed up __getitem__)")
                        continue
                    silent = 0.0
                    if bidx not in pending:
                        # the original of a resubmitted batch, arrived
                        # after the restart's copy: drop it
                        if status == "ok":
                            _shm_discard(payload)
                        continue
                    del pending[bidx]
                    feed()
                    buffered[bidx] = (status, payload)
                    while next_yield in buffered:
                        status, payload = buffered.pop(next_yield)
                        next_yield += 1
                        if status != "ok":
                            raise RuntimeError(
                                f"DataLoader worker failed: {payload}")
                        yield _shm_decode(payload, to_tensor)
            finally:
                for _ in workers:
                    try:
                        index_q.put_nowait(None)
                    except Exception:
                        pass
                # drain undelivered payloads so their segments unlink
                while True:
                    try:
                        _, status, payload = result_q.get_nowait()
                    except Exception:
                        break
                    if status == "ok":
                        _shm_discard(payload)
                for status, payload in buffered.values():
                    if status == "ok":
                        _shm_discard(payload)
                for i, w in enumerate(workers):
                    w.join(timeout=2.0)
                    if w.is_alive():
                        w.terminate()
                        w.join(timeout=2.0)
                    exits.append((i, w.exitcode, False))
                # a worker mid-collate at the first drain delivers after
                # it; only this drain after the joins unlinks its segment
                while True:
                    try:
                        _, status, payload = result_q.get(timeout=0.2)
                    except Exception:
                        break
                    if status == "ok":
                        _shm_discard(payload)
        return gen()

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
        # the worker pool and the C++ prefetcher queue batches ahead
        # themselves: no buffer-reader thread on top
        for name, make in (("process", self._process_batches),
                           ("native", self._native_batches)):
            gen = make()
            if gen is not None:
                self.transports.append(name)
                yield from gen
                return
        self.transports.append("thread")
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
