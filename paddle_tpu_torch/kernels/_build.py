"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``,
into ``build/kernels/<hash>/lib<name>.so`` at the repository root, where
``<hash>`` covers every source and header in ``csrc/`` and the compiler
flags. The build runs at first use (all sources at once, one ``nvcc``
each) and is reused while the sources are unchanged. The libraries expose
plain C entry points and are loaded with ``ctypes``: every pointer and the
stream travel as ``c_void_p``, and each entry returns ``cudaGetLastError()``
after its launches, which :func:`check` turns into an exception.
Every failure here (no ``nvcc``, a failed compile, a refused launch) raises
:class:`KernelError`, which the serving engine's replay recovery does not
absorb: no fallback hides a kernel.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, object] = {}


class KernelError(RuntimeError):
    """A kernel could not be built, or its launch was refused: a CUDA error
    at launch, or a CUDA graph given pools it was not captured with."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise KernelError(
            "nvcc not found (PATH, CUDA_HOME): the port's kernels build "
            "with the CUDA toolkit on the machine that has the card")
    return str(path)


def sources() -> Dict[str, Path]:
    """Kernel library name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _compile(nvcc: str, src: Path, out: Path) -> None:
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel library that is not built yet, in parallel.
    Returns the seconds spent (0.0 when everything was cached)."""
    with _lock:
        out_dir = build_dir()
        todo = {name: src for name, src in sources().items()
                if not (out_dir / f"lib{name}.so").exists()}
        if not todo:
            return 0.0
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            futures = [pool.submit(_compile, nvcc, src,
                                   out_dir / f"lib{name}.so")
                       for name, src in todo.items()]
            for f in futures:
                f.result()
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
                _libs[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """Look up one C entry (once) and declare its argument and result
    types."""
    fn = _bound.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _bound[symbol] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch)."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def kv_code(quant: bool) -> int:
    """The kernels' KV pool code (0 = native pool, 1 = int8 payload with
    per-row f32 scales)."""
    return 1 if quant else 0


def counters(fn, *variants: str) -> None:
    """Give kernel wrapper ``fn`` one launch counter per variant of its
    kernel (``""`` is the native one): ``fn.launches`` maps each
    variant's name (:func:`variant_name`) to its count."""
    fn.launches = {variant_name(fn, v): 0 for v in variants}


def variant_name(fn, variant: str = "") -> str:
    """``fn``'s name, with ``_<variant>`` for a quantized variant."""
    return fn.__name__ + (f"_{variant}" if variant else "")


def count(fn, variant: str = "") -> None:
    """One launch of ``fn``'s kernel in ``variant``."""
    fn.launches[variant_name(fn, variant)] += 1


def dtype_code(dtype) -> int:
    """The kernels' dtype code (0 = float32, 1 = bfloat16)."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the port's kernels take float32 or bfloat16, "
                    f"got {dtype}")
