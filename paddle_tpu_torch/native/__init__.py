"""The native (C++) data path, bound with ctypes (counterpart of
``paddle_tpu/native``).

``src/io_core.cpp`` is a copy of the JAX package's source: a splitmix64
Fisher-Yates shuffle, a multithreaded record gather and a background batch
prefetcher, so both packages draw the same batch order from the same seed.
It compiles at first use with the system ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into ``build/native/<digest>/libio_core.so`` at the
repository root, where ``<digest>`` covers the source and the flags (a
per-process temporary file and an atomic rename, so concurrent processes
never load a half-written library).

A build or load failure raises :class:`NativeCompileError` with the
compiler's output: nothing falls back silently. The only way to the NumPy
path (the same semantics, another shuffle order) is the explicit opt-out
``PADDLE_TPU_DISABLE_NATIVE=1``, as in the reference, under which
:func:`available` is False.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = ["NativeCompileError", "available", "shuffled_indices", "gather",
           "BatchPrefetcher"]

SRC = Path(__file__).resolve().parent / "src" / "io_core.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()


class NativeCompileError(RuntimeError):
    """``io_core.cpp`` did not compile or load."""


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise NativeCompileError(f"g++ could not build {SRC.name}: {e!r}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeCompileError(f"g++ failed for {SRC.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _load():
    """The loaded library (built first if needed), or None under the
    opt-out. Raises :class:`NativeCompileError` on a failed build or load."""
    global _lib
    if os.environ.get("PADDLE_TPU_DISABLE_NATIVE") == "1":
        return None
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SRC.read_bytes())
        so = BUILD_ROOT / h.hexdigest()[:16] / "libio_core.so"
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeCompileError(f"cannot load {so}: {e}") from e
        lib.ptio_shuffle.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64]
        lib.ptio_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]
        lib.ptio_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.ptio_prefetcher_create.restype = ctypes.c_void_p
        lib.ptio_prefetcher_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64]
        lib.ptio_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.ptio_prefetcher_next.restype = ctypes.c_int64
        lib.ptio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True unless ``PADDLE_TPU_DISABLE_NATIVE=1``: builds and loads the
    library (raising :class:`NativeCompileError` when that fails)."""
    return _load() is not None


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic permutation of [0, n): the native Fisher-Yates, or
    NumPy's (another order) under the opt-out."""
    lib = _load()
    if lib is None:
        return np.random.default_rng(seed).permutation(n).astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    lib.ptio_shuffle(idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     n, ctypes.c_uint64(seed & (2**64 - 1)))
    return idx


def gather(src: np.ndarray, indices: np.ndarray,
           n_threads: int = 4) -> np.ndarray:
    """dst[i] = src[indices[i]] over the leading dim: a multithreaded
    memcpy, or ``src[indices]`` under the opt-out."""
    lib = _load()
    src = np.ascontiguousarray(src)
    if lib is None:
        return src[indices]
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty((len(indices),) + src.shape[1:], src.dtype)
    rec = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib.ptio_gather(
        src.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(indices), rec, out.ctypes.data_as(ctypes.c_void_p),
        n_threads)
    return out


class BatchPrefetcher:
    """Background batch producer over parallel arrays sharing dim 0.

    The C++ producer thread shuffles (per epoch), gathers records with a
    small thread pool and keeps up to ``capacity`` batches queued while
    Python and the card consume. Iterate with ``epoch(seed)``; under the
    opt-out the batches come from NumPy."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 capacity: int = 2, n_threads: int = 4):
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("arrays must share dim 0")
        self.n = n
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._lib = _load()
        self._handle = None
        if self._lib is not None:
            ptrs = (ctypes.c_void_p * len(self.arrays))(
                *[a.ctypes.data_as(ctypes.c_void_p).value
                  for a in self.arrays])
            recs = (ctypes.c_int64 * len(self.arrays))(
                *[a.dtype.itemsize *
                  int(np.prod(a.shape[1:], dtype=np.int64))
                  for a in self.arrays])
            self._handle = self._lib.ptio_prefetcher_create(
                ptrs, recs, len(self.arrays), n, self.batch_size,
                int(drop_last), int(shuffle), capacity, n_threads)

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self, seed: int = 0):
        """Yield batches (a tuple of numpy arrays, one per input array)."""
        if self._handle is None:
            yield from self._numpy_epoch(seed)
            return
        self._lib.ptio_prefetcher_start_epoch(
            self._handle, ctypes.c_uint64(seed & (2**64 - 1)))
        while True:
            outs = [np.empty((self.batch_size,) + a.shape[1:], a.dtype)
                    for a in self.arrays]
            ptrs = (ctypes.c_void_p * len(outs))(
                *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
            got = self._lib.ptio_prefetcher_next(self._handle, ptrs)
            if got <= 0:
                return
            if got < self.batch_size:
                outs = [o[:got] for o in outs]
            yield tuple(outs)

    def _numpy_epoch(self, seed: int):
        order = (np.random.default_rng(seed).permutation(self.n)
                 if self.shuffle else np.arange(self.n))
        for lo in range(0, self.n, self.batch_size):
            idx = order[lo:lo + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield tuple(a[idx] for a in self.arrays)

    def close(self):
        if self._handle is not None:
            self._lib.ptio_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
