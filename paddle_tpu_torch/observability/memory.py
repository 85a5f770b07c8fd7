"""memwatch: where the card's memory goes.

Counterpart of ``paddle_tpu/observability/memory.py``, with its three
instruments and one accounting vocabulary (the ``SECTIONS``):

  1. **Program capture.** Each decode, chunk and speculative program's
     CUDA-graph capture on the card (``generation.serving._StepGraph``),
     its first build on the CPU, and each ``TrainStep`` batch signature's
     first step record their sections into the registry as
     ``program_memory_bytes{model,kind,bucket,extra,section}`` gauges and a
     host-side row table (:func:`program_table`). The sections keep the
     JAX package's names; on the card they mean:

       - ``argument``: bytes of the tensors the program reads (weights,
         pools, static inputs);
       - ``output``: its outputs, the tensors it writes in place
         included (XLA counts a donated buffer among the outputs too);
       - ``alias``: bytes it writes in place (the KV pools; for a train
         step the parameters and the optimizer state), the analogue of
         XLA's donation;
       - ``temp``: a graph's private memory pool, the bytes of its
         segments in ``torch.cuda.memory_snapshot()`` once captured; a
         train step's rise of
         ``torch.cuda.max_memory_allocated`` over its first step of a
         batch signature (after ``reset_peak_memory_stats``);
       - ``generated_code``: 0;
       - ``peak``: argument + output - alias + temp + generated_code.

     On the CPU a row counts ``argument``, ``output`` and ``alias`` from
     the tensors and has ``temp = 0``: the eager step has no private pool
     and the CPU allocator keeps no watermark (a designed difference; the
     JAX package compiles each program a second time for XLA's numbers).
     A measurement that fails is counted in
     ``memwatch_capture_failures{kind}``, never raised.
  2. **Watermarks.** :func:`sample_device_memory` publishes the card's
     caching-allocator watermarks under the JAX package's stat names, and
     the host's peak RSS; the serving engine's pool ledger rides the
     metrics snapshot itself (``kv_pool_pages``/``kv_pool_bytes``).
  3. **Estimator and planner.** :func:`estimate_program`,
     :func:`estimate_decode_program`, :func:`estimate_prefill_program`
     and :func:`estimate_engine_memory` are the JAX package's arithmetic,
     copied: for the same inputs they return exactly what it returns
     (their temp models were fitted to XLA's buffer assignment, so beside
     the card's measured ``temp`` they are an estimate, not a bound).
     :func:`plan_fused_layers` prices the Hopper N-layer decode kernel
     instead of TPU VMEM: the f32 scratch ``fused_multi_block_decode``
     allocates and the kernels' shared memory per block.

Gating, as in the JAX package: capture is on when ``FLAGS_telemetry`` and
``FLAGS_memwatch`` are, resolved when a program cache or a ``TrainStep``
is built. Every measurement runs on the host around a capture or a step,
never inside a captured graph, and neither flag is in ``PROGRAM_FLAGS``.
"""

from __future__ import annotations

import resource
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "enabled", "capture_program", "record_program", "program_table",
    "clear_program_table", "format_program_table", "stats_from_tensors",
    "tensor_bytes", "sample_device_memory", "section",
    "estimate_program", "estimate_decode_program", "estimate_prefill_program",
    "estimate_engine_memory", "plan_fused_layers", "fits",
    "sharded_param_bytes", "compare_program_rows", "PoolGeometry",
    "ModelDims", "weight_bytes", "aval_bytes", "fused_decode_scratch",
    "MEMWATCH_SCHEMA", "SECTIONS", "TABLE_COLUMNS", "DEVICE_STATS",
]

MEMWATCH_SCHEMA = 1

# the sections every surface (gauges, table rows, estimator output) agrees
# on
SECTIONS = ("argument", "output", "temp", "alias", "generated_code", "peak")

_TABLE: Dict[Tuple[str, str, int, str], Dict[str, Any]] = {}
_TABLE_LOCK = threading.Lock()


def enabled() -> bool:
    """The capture gate: ``FLAGS_telemetry`` and ``FLAGS_memwatch``.
    Resolve it when an instrumented object is built."""
    from .. import flags
    return bool(flags.get_flag("telemetry")) and \
        bool(flags.get_flag("memwatch"))


# --------------------------------------------------------------- capture
def _tensors(obj, out: Dict[Tuple[int, str], int]) -> None:
    if isinstance(obj, torch.Tensor):
        if obj.numel():
            key = (obj.data_ptr(), str(obj.device))
            out[key] = max(out.get(key, 0),
                           obj.numel() * obj.element_size())
    elif isinstance(obj, torch.nn.Module):
        for t in obj.parameters():
            _tensors(t, out)
        for t in obj.buffers():
            _tensors(t, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (tensors, modules' parameters and
    buffers, and dicts, lists and tuples of them, a pool's
    ``QuantizedPages`` and stacked weights included), each storage counted
    once."""
    seen: Dict[Tuple[int, str], int] = {}
    for o in objs:
        _tensors(o, seen)
    return int(sum(seen.values()))


def stats_from_tensors(arguments, outputs, aliased, temp: int = 0
                       ) -> Dict[str, int]:
    """The section dict of one program: ``arguments`` (what it reads),
    ``outputs`` (what it returns) and ``aliased`` (what it writes in place,
    among both) counted by :func:`tensor_bytes`; ``temp`` as measured."""
    out = {"argument": tensor_bytes(arguments),
           "output": tensor_bytes(outputs),
           "temp": int(temp), "alias": tensor_bytes(aliased),
           "generated_code": 0}
    out["peak"] = (out["argument"] + out["output"] - out["alias"]
                   + out["temp"] + out["generated_code"])
    return out


def record_program(kind: str, bucket: int, stats: Dict[str, int],
                   extra: Any = (), model: str = "") -> None:
    """Bank one program's section dict: the registry gauges
    ``program_memory_bytes{model,kind,bucket,extra,section}`` (the last
    write wins) and the row table. ``model`` keeps same-shaped programs of
    different models apart (a signature prefix)."""
    from .metrics import registry
    ex = _extra_str(extra)
    fam = registry().gauge(
        "program_memory_bytes",
        "memory sections of captured programs (CUDA graphs, train steps), "
        "by section (peak = argument + output - alias + temp + code)",
        labels=("model", "kind", "bucket", "extra", "section"))
    for sec in SECTIONS:
        fam.labels(model=model, kind=kind, bucket=str(bucket), extra=ex,
                   section=sec).set(float(stats.get(sec, 0)))
    with _TABLE_LOCK:
        row = _TABLE.setdefault((model, kind, int(bucket), ex), {
            "model": model, "kind": kind, "bucket": int(bucket),
            "extra": ex, "captures": 0})
        row.update({sec: int(stats.get(sec, 0)) for sec in SECTIONS})
        row["captures"] += 1


def capture_program(kind: str, bucket: int, extra: Any,
                    measure: Callable[[], Dict[str, int]],
                    model: str = "") -> bool:
    """Measure and record one program: ``measure()`` returns its section
    dict. A measurement that raises is counted in
    ``memwatch_capture_failures{kind}`` and never raised: accounting must
    not take down a step that already ran."""
    try:
        stats = measure()
    except Exception:
        from .metrics import registry
        registry().counter(
            "memwatch_capture_failures",
            "program memory measurements that failed",
            labels=("kind",)).labels(kind=kind).inc()
        return False
    record_program(kind, bucket, stats, extra, model=model)
    return True


def program_table() -> List[Dict[str, Any]]:
    """Every captured program's row, sorted and JSON-able."""
    with _TABLE_LOCK:
        rows = [dict(r) for r in _TABLE.values()]
    return sorted(rows, key=lambda r: (r["model"], r["kind"], r["bucket"],
                                       r["extra"]))


def clear_program_table() -> None:
    with _TABLE_LOCK:
        _TABLE.clear()


TABLE_COLUMNS = ("model", "kind", "bucket", "extra", "argument", "output",
                 "temp", "alias", "peak")


def format_program_table(rows: Sequence[Dict[str, Any]]) -> str:
    """Program rows as a fixed-width table."""
    lines = ["  ".join(f"{h:>14s}" for h in TABLE_COLUMNS)]
    for r in rows:
        lines.append("  ".join(f"{str(r.get(h, '')):>14s}"
                               for h in TABLE_COLUMNS))
    return "\n".join(lines)


def _extra_str(extra: Any) -> str:
    if extra in ((), None, ""):
        return ""
    if isinstance(extra, (tuple, list)):
        return ",".join(str(e) for e in extra)
    return str(extra)


# ---------------------------------------------------- device watermarks
# the JAX package's stat name -> torch.cuda.memory_stats() key
DEVICE_STATS = {"bytes_in_use": "allocated_bytes.all.current",
                "peak_bytes_in_use": "allocated_bytes.all.peak",
                "bytes_reserved": "reserved_bytes.all.current",
                "peak_bytes_reserved": "reserved_bytes.all.peak"}


def sample_device_memory(publish: bool = True) -> Dict[str, Any]:
    """Each CUDA card's allocator watermarks (none without a card: the
    CPU reports nothing, as the JAX package's CPU backend does) and the
    host process's peak RSS. Publishes ``device_memory_bytes{device,stat}``
    and ``host_memory_bytes{stat}`` gauges when telemetry is on and returns
    the JSON-able sample either way."""
    out: Dict[str, Any] = {"devices": {}, "host": {}}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out["devices"][str(i)] = {name: int(stats.get(key, 0))
                                      for name, key in DEVICE_STATS.items()}
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # linux reports ru_maxrss in KiB; darwin in bytes
    scale = 1 if sys.platform == "darwin" else 1024
    out["host"]["peak_rss"] = int(ru.ru_maxrss) * scale
    if publish:
        from . import enabled as _telemetry_on
        if _telemetry_on():
            from .metrics import registry
            r = registry()
            if out["devices"]:
                fam = r.gauge("device_memory_bytes",
                              "CUDA caching-allocator watermarks "
                              "(torch.cuda.memory_stats())",
                              labels=("device", "stat"))
                for dev, stats in out["devices"].items():
                    for k, v in stats.items():
                        fam.labels(device=dev, stat=k).set(float(v))
            fam = r.gauge("host_memory_bytes",
                          "host process memory watermarks",
                          labels=("stat",))
            for k, v in out["host"].items():
                fam.labels(stat=k).set(float(v))
    return out


def section() -> Dict[str, Any]:
    """The ``"memory"`` section a report embeds beside its telemetry
    snapshot: the schema, the captured program table and the device and
    host watermarks."""
    return {"schema": MEMWATCH_SCHEMA, "programs": program_table(),
            "watermarks": sample_device_memory()}


# ------------------------------------------------------------ estimator
# The JAX package's analytic twin of its compiled-memory capture, copied
# as plain arithmetic (its calibration constants were fitted to XLA's
# CompiledMemoryStats on the CPU).

_DECODE_TEMP_K = 1.25     # decode: full working-set chain stays live-ish
_PREFILL_TEMP_K = 1.0     # prefill/chunk: two largest stage buffers

_NAMED_ITEMSIZE = {"bfloat16": 2, "bf16": 2}


def _itemsize(dtype) -> int:
    """Bytes of one element of a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if isinstance(dtype, str) and dtype in _NAMED_ITEMSIZE:
        return _NAMED_ITEMSIZE[dtype]
    return np.dtype(dtype).itemsize


def aval_bytes(x) -> int:
    """Bytes of one tensor, or of a ``(shape, dtype)`` pair."""
    if isinstance(x, tuple) and len(x) == 2:
        shape, dtype = x
    else:
        shape, dtype = x.shape, x.dtype
    return int(np.prod(tuple(shape), dtype=np.int64)) * _itemsize(dtype)


def estimate_program(arg_avals: Sequence[Any], out_avals: Sequence[Any],
                     donated: Sequence[int] = (),
                     temp: int = 0, generated_code: int = 0
                     ) -> Dict[str, int]:
    """Section estimate from flat lists of arguments and outputs:
    ``donated`` indexes into ``arg_avals``; those bytes alias outputs
    instead of doubling the peak."""
    arg = sum(aval_bytes(a) for a in arg_avals)
    out = sum(aval_bytes(a) for a in out_avals)
    alias = sum(aval_bytes(arg_avals[i]) for i in donated)
    est = {"argument": arg, "output": out, "temp": int(temp),
           "alias": alias, "generated_code": int(generated_code)}
    est["peak"] = arg + out - alias + est["temp"] + est["generated_code"]
    return est


class PoolGeometry:
    """The KV pool's shape, as :class:`PagedKVCache`'s constructor takes
    it."""

    __slots__ = ("num_layers", "num_pages", "page_size", "num_kv_heads",
                 "head_dim", "max_pages_per_seq", "dtype", "kv_quant")

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, max_pages_per_seq: int,
                 dtype: Any = "float32", kv_quant: bool = False):
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.dtype = dtype
        # an int8 pool: the int8 payload and one f32 scale per (head,
        # page, token) row beside it
        self.kv_quant = bool(kv_quant)

    @classmethod
    def of_pool(cls, pool) -> "PoolGeometry":
        """The geometry of a live :class:`PagedKVCache`."""
        from ..kernels.paged_attention import QuantizedPages
        k0 = pool.k_pages[0]
        quant = isinstance(k0, QuantizedPages)
        hkv, num_pages, page, d = k0.shape
        return cls(len(pool.k_pages), num_pages, page, hkv, d,
                   pool.max_pages_per_seq,
                   k0.q.dtype if quant else k0.dtype, kv_quant=quant)

    def pool_bytes(self) -> int:
        """Both pools of every layer, the aliased block. An int8 pool bills
        the payload and the f32 row scales (head_dim + 4 bytes a
        token-head)."""
        per_elem = (self.head_dim * _itemsize(self.dtype)
                    + (4 if self.kv_quant else 0))
        return (self.num_layers * 2 * self.num_kv_heads * self.num_pages
                * self.page_size * per_elem)

    def tables_bytes(self, batch: int) -> int:
        """Block table and seq_lens of one dispatch (int32)."""
        return batch * (self.max_pages_per_seq + 1) * 4

    @property
    def max_seq(self) -> int:
        return self.max_pages_per_seq * self.page_size


class ModelDims:
    """The model dimensions the estimates read: from a config with the
    Llama or GPT field names, or given explicitly (a model too big to
    build)."""

    __slots__ = ("hidden", "layers", "heads", "kv_heads", "intermediate",
                 "vocab", "param_count")

    def __init__(self, hidden: int, layers: int, heads: int,
                 kv_heads: Optional[int], intermediate: int, vocab: int,
                 param_count: Optional[int] = None):
        self.hidden = int(hidden)
        self.layers = int(layers)
        self.heads = int(heads)
        self.kv_heads = int(kv_heads if kv_heads else heads)
        self.intermediate = int(intermediate)
        self.vocab = int(vocab)
        self.param_count = param_count

    @classmethod
    def of_config(cls, cfg) -> "ModelDims":
        """The dims of the port's ``LlamaConfig`` or ``GPTConfig``."""
        inter = getattr(cfg, "intermediate_size", None)
        if inter is None:                      # GPT publishes a 4x MLP
            inter = 4 * cfg.hidden_size
        n = cfg.num_params() if hasattr(cfg, "num_params") else None
        return cls(cfg.hidden_size, cfg.num_hidden_layers,
                   cfg.num_attention_heads,
                   getattr(cfg, "num_key_value_heads", None),
                   inter, cfg.vocab_size, n)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def _decode_temp(dims: ModelDims, geom: PoolGeometry, batch: int) -> int:
    """Decode-step temp: each row's working set of one layer chain (x/qkv,
    attention scores over the table's width, the FFN) summed over layers,
    plus the logits row, all f32, times the live-set factor."""
    per_layer = (4 * dims.hidden            # x, q, attn-out, residual
                 + 2 * dims.kv_dim          # k, v new-token rows
                 + dims.heads * geom.max_seq   # attention scores
                 + 2 * dims.intermediate)   # gate/up FFN halves
    elems = batch * (dims.layers * per_layer + dims.vocab)
    return int(_DECODE_TEMP_K * elems * 4)


def _prefill_temp(dims: ModelDims, geom: PoolGeometry, s: int,
                  chunked: bool = False) -> int:
    """Prefill or chunk temp (b = 1, S query tokens): the two largest stage
    buffers (scores, the FFN intermediate, the logits, the QKV block).
    ``chunked``: attention reads the pool through the block table a page
    group at a time (online softmax), so no full-context K/V view or S x
    max_seq score matrix exists."""
    if chunked:
        pages = -(-geom.max_seq // geom.page_size)
        gk = min(pages, max(1, 128 // geom.page_size)) * geom.page_size
        stages = [
            dims.heads * s * gk,                 # page-group score block
            2 * gk * dims.kv_dim,                # gathered K+V group block
            2 * dims.heads * s * dims.head_dim,  # online-softmax acc carry
            2 * s * dims.intermediate,           # gate/up FFN halves
            s * dims.vocab,                      # logits
            s * 4 * dims.hidden,                 # q/k/v/x block
        ]
    else:
        stages = [
            dims.heads * s * geom.max_seq,      # attention scores
            2 * geom.max_seq * dims.kv_dim,     # gathered k+v view
            2 * s * dims.intermediate,          # gate/up FFN halves
            s * dims.vocab,                     # logits
            s * 4 * dims.hidden,                # q/k/v/x block
        ]
    top2 = sum(sorted(stages)[-2:])
    return int(_PREFILL_TEMP_K * top2 * 4)


def _nlayer_slice_temp(dims: ModelDims, batch: int) -> int:
    """The N-layer decode program's temp floor: one merged layer slice of
    the stacked weights and the merged activations."""
    slice_elems = dims.hidden * max(2 * dims.intermediate,
                                    dims.heads * dims.head_dim
                                    + 2 * dims.kv_dim)
    act_elems = batch * (2 * dims.intermediate + 2 * dims.hidden)
    return 4 * (slice_elems + act_elems)


def _kv_dequant_temp(dims: ModelDims, geom: PoolGeometry,
                     batch: int) -> int:
    """int8-pool decode adder: one f32 dequantized K view of the gathered
    context."""
    pages = -(-geom.max_seq // geom.page_size)
    return 4 * dims.kv_heads * batch * pages * geom.page_size \
        * dims.head_dim


def _int4_unpack_temp(dims: ModelDims, group_layers: int) -> int:
    """int4 stacked-weight adder: the group's merged f32 weights but wd."""
    merged = (dims.hidden * (dims.heads * dims.head_dim
                             + 2 * dims.kv_dim)       # wqkv
              + dims.heads * dims.head_dim * dims.hidden   # wo
              + dims.hidden * 2 * dims.intermediate)       # gate|up
    return 4 * group_layers * merged


def estimate_decode_program(dims: ModelDims, geom: PoolGeometry,
                            batch: int, param_bytes: int,
                            fused_layers: int = 1,
                            int4_weights: bool = False) -> Dict[str, int]:
    """Predicted sections of one decode-step program (fused, generic or
    N-layer): parameters, pools and tables in; pools and token ids out."""
    pool = geom.pool_bytes()
    tables = geom.tables_bytes(batch)
    arg = param_bytes + pool + tables + batch * 4         # toks (B,1)
    out = pool + tables + batch * 4                       # argmax ids
    temp = _decode_temp(dims, geom, batch)
    if int(fused_layers) > 1:
        temp = max(temp, _nlayer_slice_temp(dims, batch))
    if geom.kv_quant:
        temp += _kv_dequant_temp(dims, geom, batch)
    if int4_weights:
        temp += _int4_unpack_temp(dims, int(fused_layers))
    return {
        "argument": arg, "output": out,
        "temp": temp,
        "alias": pool, "generated_code": 0,
        "peak": arg + out - pool + temp,
    }


def estimate_prefill_program(dims: ModelDims, geom: PoolGeometry,
                             s: int, param_bytes: int,
                             chunked: bool = False) -> Dict[str, int]:
    """Predicted sections of a b = 1 prefill of length ``s``, or of a chunk
    of ``s`` tokens (``chunked=True``)."""
    pool = geom.pool_bytes()
    tables = geom.tables_bytes(1)
    arg = param_bytes + pool + tables + s * 4             # ids (1, S)
    out = pool + tables + 4                               # argmax id
    temp = _prefill_temp(dims, geom, s, chunked=chunked)
    return {"argument": arg, "output": out, "temp": temp,
            "alias": pool, "generated_code": 0,
            "peak": arg + out - pool + temp}


# ------------------------------------------------------ what-if planner
_WEIGHT_BYTES = {"float32": 4.0, "f32": 4.0, "bfloat16": 2.0, "bf16": 2.0,
                 "float16": 2.0, "int8": 1.0, "int4": 0.5}


def weight_bytes(param_count: int, dtype: str,
                 scale_group: int = 128) -> int:
    """Model weight bytes for a storage dtype; a quantized dtype adds one
    f32 scale per ``scale_group`` weights."""
    per = _WEIGHT_BYTES[str(dtype)]
    total = param_count * per
    if per < 2.0:                       # quantized: add the scales
        total += param_count / scale_group * 4
    return int(total)


class _ShardedDims(ModelDims):
    """One shard of a tensor-parallel engine: heads, kv heads and the MLP
    width divide by ``tp``; ``head_dim`` stays the whole model's."""

    __slots__ = ("_head_dim",)

    def __init__(self, dims: ModelDims, tp: int):
        super().__init__(dims.hidden, dims.layers, dims.heads // tp,
                         dims.kv_heads // tp, dims.intermediate // tp,
                         dims.vocab, dims.param_count)
        self._head_dim = dims.head_dim

    @property
    def head_dim(self) -> int:
        return self._head_dim


def estimate_engine_memory(dims: ModelDims, *,
                           page_size: int = 64,
                           page_budget: Optional[int] = None,
                           max_batch: int = 8,
                           max_seq_len: int = 1024,
                           chunk: int = 0,
                           weight_dtype: str = "bfloat16",
                           kv_dtype: str = "bfloat16",
                           host_tier_pages: int = 0,
                           param_count: Optional[int] = None,
                           draft_dims: Optional[ModelDims] = None,
                           spec_gamma: int = 0,
                           draft_param_count: Optional[int] = None,
                           draft_weight_dtype: Optional[str] = None,
                           tp: int = 1
                           ) -> Dict[str, Any]:
    """The what-if planner: a serving configuration's steady-state device
    memory, as a breakdown and a ``total`` to hold against a card.
    ``page_budget``: usable pages (the null page rides on top); None
    takes the worst case. ``host_tier_pages`` prices the host tier
    (``host_tier``, never summed into the device total). ``draft_dims``
    prices speculative decoding: the draft's weights, its worst-case pool
    and the verify's workspace. ``tp`` prices one shard of a
    tensor-parallel engine (the JAX package's arithmetic, a shard a
    device; the port's tp > 1 engine keeps every shard on its one device)
    and refuses, as that engine does, a
    degree that does not divide heads, kv heads and the MLP width, or int4
    weights under ``tp > 1``."""
    n_params = param_count or dims.param_count
    if n_params is None:
        raise ValueError("need param_count (config.num_params() or "
                         "explicit)")
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp > 1 and (dims.heads % tp or dims.kv_heads % tp
                   or dims.intermediate % tp):
        raise ValueError(
            f"tp={tp} must divide heads ({dims.heads}), kv_heads "
            f"({dims.kv_heads}) and intermediate ({dims.intermediate}) "
            f"— the engine refuses this config too")
    if tp > 1 and str(weight_dtype) == "int4":
        raise ValueError(
            "int4 weight tiles cannot be sharded: two-nibble row-pairing "
            "does not commute with the head-shard permutation — the "
            "engine refuses this config too (serve int8 or bf16 under tp)")
    sdims = _ShardedDims(dims, tp) if tp > 1 else dims
    pages_per_seq = -(-max_seq_len // page_size)
    usable = (int(page_budget) if page_budget
              else max_batch * pages_per_seq)
    geom = PoolGeometry(sdims.layers, usable + 1, page_size,
                        sdims.kv_heads,
                        sdims.head_dim, pages_per_seq, np.dtype(
                            "int8" if str(kv_dtype) == "int8"
                            else "float16"),  # 2B stand-in for bf16
                        kv_quant=str(kv_dtype) == "int8")
    if str(kv_dtype) in ("bfloat16", "bf16", "float16"):
        kv_item = 2
    elif str(kv_dtype) == "int8":
        kv_item = 1
    else:
        kv_item = _itemsize(kv_dtype)
    pool = (sdims.layers * 2 * sdims.kv_heads * (usable + 1) * page_size
            * sdims.head_dim * kv_item)
    if str(kv_dtype) == "int8":
        # one f32 scale per head-token row of k and of v
        pool += (sdims.layers * 2 * sdims.kv_heads * (usable + 1)
                 * page_size * 4)
    if tp > 1:
        # embedding and LM head replicate on every shard; every block
        # weight splits by tp
        replicated = min(int(n_params), 2 * dims.vocab * dims.hidden)
        shard_params = replicated + (int(n_params) - replicated) // tp
        weights = weight_bytes(shard_params, weight_dtype)
    else:
        weights = weight_bytes(n_params, weight_dtype)
    decode_tmp = _decode_temp(sdims, geom, max_batch)
    chunk_tmp = (_prefill_temp(sdims, geom, chunk, chunked=True)
                 if chunk else 0)
    tables = geom.tables_bytes(max_batch)
    # speculative decoding: draft weights and the draft's worst-case pool
    # are resident; the verify and the draft's programs add workspace
    # (dispatches never overlap, so the max counts, not the sum)
    draft_weights = draft_pool = verify_tmp = draft_tmp = 0
    if draft_dims is not None:
        gamma = max(1, int(spec_gamma))
        dn = draft_param_count or draft_dims.param_count
        if dn is None:
            raise ValueError("need draft_param_count "
                             "(config.num_params() or explicit)")
        draft_weights = weight_bytes(
            dn, draft_weight_dtype or weight_dtype)
        dgeom = PoolGeometry(
            draft_dims.layers, 1 + max_batch * pages_per_seq, page_size,
            draft_dims.kv_heads, draft_dims.head_dim, pages_per_seq,
            geom.dtype, kv_quant=geom.kv_quant)
        draft_pool = dgeom.pool_bytes()
        verify_tmp = _prefill_temp(sdims, geom, gamma + 1, chunked=True)
        draft_tmp = max(_decode_temp(draft_dims, dgeom, 1),
                        _prefill_temp(draft_dims, dgeom, gamma + 1))
    margin = max(64 << 20, int(0.05 * (weights + draft_weights)))
    workspace = max(decode_tmp, chunk_tmp, verify_tmp, draft_tmp)
    total = (weights + draft_weights + pool + draft_pool + workspace
             + tables + margin)
    # the host tier: the device pool's bytes a page, against host memory
    bytes_per_page = pool // (usable + 1)
    host_tier = int(host_tier_pages) * bytes_per_page
    return {
        "dims": {"hidden": dims.hidden, "layers": dims.layers,
                 "heads": dims.heads, "kv_heads": dims.kv_heads,
                 "intermediate": dims.intermediate, "vocab": dims.vocab,
                 "params": int(n_params)},
        "config": {"page_size": page_size, "usable_pages": usable,
                   "max_batch": max_batch, "max_seq_len": max_seq_len,
                   "chunk": chunk, "weight_dtype": str(weight_dtype),
                   "kv_dtype": str(kv_dtype),
                   "host_tier_pages": int(host_tier_pages),
                   "spec_gamma": (max(1, int(spec_gamma))
                                  if draft_dims is not None else 0),
                   "tp": tp},
        "breakdown": {
            "weights": weights, "kv_pool": pool,
            **({"draft_weights": draft_weights,
                "draft_kv_pool": draft_pool,
                "spec_verify_workspace": verify_tmp,
                "draft_workspace": draft_tmp}
               if draft_dims is not None else {}),
            "decode_workspace": decode_tmp,
            "chunk_prefill_workspace": chunk_tmp,
            "block_tables": tables,
            "xla_code_and_runtime_margin": margin,
        },
        "total": int(total),
        "host_tier": {"pages": int(host_tier_pages),
                      "bytes": int(host_tier),
                      "bytes_per_page": int(bytes_per_page)},
    }


# --------------------------------------- the N-layer decode kernel's price
# csrc/block_decode.cuh and csrc/decode_split.cuh, copied: the GEMV's
# threads, unroll and target grid, the int4 GEMV's columns a tile, the
# epilogue and append block sizes, the split-KV block's key rows
_GV_WARPS, _GV_UNROLL, _GV_TARGET_BLOCKS, _GV_MAXB = 8, 4, 1024, 8
_GV4_TARGET_BLOCKS = _GV_TARGET_BLOCKS // 2
_I4_COLS = 32 * 8
_EPI_THREADS, _APPEND_THREADS = 256, 128
_DS_ROWS = 128 // 16
_F32 = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gemv_ks(w4: bool, k: int, col_tiles: int) -> int:
    """``gemv_split(K, tiles).ks`` (``gemv4_split`` over K/2 packed rows
    for int4 tiles): the contraction's split."""
    step = _GV_WARPS * _GV_UNROLL
    if w4:
        want = _cdiv(_GV4_TARGET_BLOCKS, col_tiles)
        rows = _cdiv(_cdiv(k // 2, want), step) * step
        return _cdiv(k // 2, rows)
    want = _cdiv(_GV_TARGET_BLOCKS, col_tiles)
    rows = _cdiv(_cdiv(k, want), step) * step
    return _cdiv(k, rows)


def _phase_part(w4: bool, k: int, b: int, widths, cols: int) -> int:
    c = _I4_COLS if w4 else cols
    tiles = sum(_cdiv(n, c) for n in widths)
    return _gemv_ks(w4, k, tiles) * b * sum(widths)


def fused_decode_scratch(io_dtype_bytes: int, int4_weights: bool, batch: int,
                         hidden: int, heads: int, kv_heads: int,
                         head_dim: int, intermediate: int,
                         nsplit: int) -> Tuple[int, int]:
    """``(activations, total)``: f32 elements of the fused decode's scratch
    before its partial-sum region, and in all. ``ptt::layout`` of
    ``csrc/block_decode.cuh`` (what ``ptt_fused_multi_block_decode_scratch``
    returns), as a Python formula. The scratch serves one layer at a time,
    so it is the same for every group size N."""
    b, h, nh, nkv, d = batch, hidden, heads, kv_heads, head_dim
    cols = 32 * (8 if io_dtype_bytes == 2 else 4)
    acts = (b * h + b * nh * d + 2 * b * nkv * d + b * nh * d + b * h
            + b * intermediate + 2 * b * nkv * d + 2 * b * nkv)
    w4 = bool(int4_weights)
    part = max(_phase_part(w4, h, b, (nh * d, nkv * d, nkv * d), cols),
               _phase_part(w4, nh * d, b, (h,), cols),
               _phase_part(w4, h, b, (intermediate, intermediate), cols),
               _phase_part(w4, intermediate, b, (h,), cols))
    if nsplit > 1:
        part = max(part, nsplit * b * nh * (d + 2))
    return acts, acts + part


def plan_fused_layers(dims: ModelDims, *, fused_layers: int,
                      batch: int = 8, page_size: int = 64,
                      io_dtype_bytes: int = 2,
                      vmem_limit: int = 48 << 10,
                      max_seq_len: int = 1024, int4_weights: bool = False,
                      sm_count: int = 132,
                      hbm_bytes: int = 80 * 10 ** 9) -> Dict[str, Any]:
    """Price the Hopper N-layer fused decode (``fused_multi_block_decode``)
    and say whether ``fused_layers`` fits the card.

    The JAX package prices the TPU kernel's VMEM working set, which grows
    with N (two page blocks a grouped layer). The CUDA kernel runs the
    group's layers one after another over one f32 scratch in device memory
    and streams weights through registers, so nothing here grows with N:
    ``breakdown`` holds the GEMV kernels' shared memory per block
    (``weight_stream_buffers``: their cross-warp reduction), the scratch's
    activation rows (``activation_io_buffers``), the split-KV attention's
    shared memory per block (``kv_page_buffers``) and the whole scratch
    (``scratch``, what ``ptt_fused_multi_block_decode_scratch`` returns,
    in bytes, at the attention's part count for ``max_seq_len``).
    ``vmem_limit`` is the card's static shared memory a block (48 KiB);
    ``fits`` holds the largest block's shared memory to it and the
    scratch (``total``) to ``hbm_bytes``. ``io_dtype_bytes``: 2 for bf16,
    4 for f32; ``sm_count`` sets the attention's part count as the wrapper
    does (132 on the H100)."""
    from ..kernels.paged_attention import decode_split_plan
    n = int(fused_layers)
    if n < 1:
        raise ValueError(f"fused_layers must be >= 1, got {n}")
    if io_dtype_bytes not in (2, 4):
        raise ValueError(f"io_dtype_bytes must be 2 (bf16) or 4 (f32), "
                         f"got {io_dtype_bytes}")
    b = int(batch)
    maxp = _cdiv(int(max_seq_len), int(page_size))
    _, nsplit = decode_split_plan(b, dims.heads, dims.kv_heads, maxp,
                                  int(page_size), int(sm_count))
    acts, total = fused_decode_scratch(
        io_dtype_bytes, int4_weights, b, dims.hidden, dims.heads,
        dims.kv_heads, dims.head_dim, dims.intermediate, nsplit)
    cols = _I4_COLS if int4_weights else 32 * (8 if io_dtype_bytes == 2
                                                else 4)
    gemv_smem = _GV_WARPS * cols * _F32
    rep = dims.heads // dims.kv_heads
    rg = 1 if rep == 1 else 2 if rep == 2 else 4 if rep <= 4 else 8
    dp = 64 if dims.head_dim <= 64 else 128
    attn_smem = _DS_ROWS * rg * (dp + 2) * _F32
    shared = max(gemv_smem, attn_smem, (_EPI_THREADS // 32) * _F32,
                 2 * (_APPEND_THREADS // 32) * _F32)
    scratch = total * _F32
    return {
        "fused_layers": n, "batch": b,
        "b_pad": (_cdiv(b, _GV_MAXB) * _GV_MAXB if b > _GV_MAXB
                  else 1 << (b - 1).bit_length()),
        "page_size": int(page_size), "io_dtype_bytes": int(io_dtype_bytes),
        "breakdown": {
            "weight_stream_buffers": gemv_smem,
            "activation_io_buffers": acts * _F32,
            "kv_page_buffers": attn_smem,
            "scratch": scratch,
        },
        "total": scratch,
        "shared_per_block": shared,
        "nsplit": int(nsplit),
        "vmem_limit": int(vmem_limit),
        "hbm_bytes": int(hbm_bytes),
        "fits": shared <= vmem_limit and scratch <= hbm_bytes,
        "headroom_bytes": int(vmem_limit - shared),
    }


def fits(plan: Dict[str, Any], hbm_bytes: int) -> Dict[str, Any]:
    """Verdict and headroom of one planner breakdown against a card."""
    total = plan["total"]
    return {"hbm_bytes": int(hbm_bytes), "total": int(total),
            "fits": total <= hbm_bytes,
            "headroom_bytes": int(hbm_bytes - total)}


# --------------------------------------------- sharded-state accounting
def sharded_param_bytes(shape: Sequence[int], dtype: Any, spec,
                        mesh_shape: Dict[str, int]) -> int:
    """Bytes a device holds of one sharded array: each dimension divided by
    its mesh axes, rounded up (a dimension that does not divide pads up on
    the device)."""
    n = 1
    entries = tuple(spec) if spec is not None else ()
    for i, dim in enumerate(shape):
        denom = 1
        if i < len(entries) and entries[i] is not None:
            entry = entries[i]
            for name in ((entry,) if isinstance(entry, str) else entry):
                denom *= int(mesh_shape[name])
        n *= -(-int(dim) // denom)
    return n * _itemsize(dtype)


# -------------------------------------------------------- regression gate
def compare_program_rows(banked: List[Dict[str, Any]],
                         current: List[Dict[str, Any]],
                         tolerance: float = 0.10) -> List[Dict[str, Any]]:
    """Every program whose ``temp`` or ``peak`` grew past ``tolerance``
    against a banked table (``"grew"``); programs in one table only are
    reported as ``"missing"`` / ``"new"``."""
    key = lambda r: (r.get("model", ""), r["kind"], r["bucket"],
                     r.get("extra", ""))
    cur = {key(r): r for r in current}
    findings: List[Dict[str, Any]] = []
    seen = set()
    for row in banked:
        k = key(row)
        seen.add(k)
        now = cur.get(k)
        if now is None:
            findings.append({"model": row.get("model", ""),
                             "kind": row["kind"], "bucket": row["bucket"],
                             "extra": row.get("extra", ""),
                             "verdict": "missing"})
            continue
        for sec in ("temp", "peak"):
            old_v, new_v = int(row.get(sec, 0)), int(now.get(sec, 0))
            # a banked zero is no free pass: 0 -> anything is growth
            if new_v > old_v * (1.0 + tolerance) and new_v > old_v:
                findings.append({
                    "model": row.get("model", ""),
                    "kind": row["kind"], "bucket": row["bucket"],
                    "extra": row.get("extra", ""), "section": sec,
                    "banked": old_v, "current": new_v,
                    "growth": (round(new_v / old_v - 1.0, 4)
                               if old_v else None),
                    "verdict": "grew"})
    for k, row in cur.items():
        if k not in seen:
            findings.append({"model": row.get("model", ""),
                             "kind": row["kind"], "bucket": row["bucket"],
                             "extra": row.get("extra", ""),
                             "verdict": "new"})
    return findings
