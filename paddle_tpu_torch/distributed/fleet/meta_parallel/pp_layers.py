"""Pipeline layer segmentation: ``LayerDesc`` / ``SharedLayerDesc`` /
``PipelineLayer`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``).

The reference is single-controller: its ``PipelineLayer`` builds every
entry, and its pipelined step stacks the uniform block region over the
``pp`` mesh axis while the prefix (embedding) and suffix (final norm,
head) run replicated on every device. Here each pipeline stage is a
process and, as in upstream Paddle, builds only its own entries:

- Placement follows what the reference executes, not ``segment_parts``:
  at one virtual stage a rank (``V = 1``) stage s holds
  ``stage_block_counts()[s]`` blocks of the stack region; at ``V > 1``
  rank s holds the depth chunks ``{s, s + S, ...}`` of ``n // (S V)``
  blocks each and the blocks left over join the suffix. The prefix lives
  on stage 0, the suffix on stage S - 1 (the reference replicates them).
- Entries are built in the order of their global index and registered
  under ``str(idx)``, so parameter names are the reference's
  ``"{idx}.{rel}"``. Each entry draws its weights from a generator of its
  own, seeded from one draw of the layer's ``generator``: every rank
  consumes the same randomness whatever it builds, and a stage's weights
  do not depend on which stage built them.
- A ``SharedLayerDesc`` key whose uses fall on several stages (a tied
  embedding and head) is built on each of them, one entry per rank
  registered under its first local index. :attr:`shared_aliases` maps a
  copy's shared weight to the owner's name (the first use overall, where
  the reference keeps it) and the copy's other parameters (which no use
  reads) to None, and :attr:`shared_groups` holds, for each such
  key, the group of this rank's copies (the ranks of its other
  coordinates at the holding stages): the step sums the tied weight's
  gradient there.

Without a pipeline group of more than one live rank (``num_stages``
alone, or one process) every entry is built and :meth:`forward` runs the
whole stack, the reference's eager path. A ``LayerDesc`` is built with
the ``device``, ``dtype`` and ``generator`` keywords its class's
constructor takes (the port's layers take them; ``weight_attr`` is not
ported).

Designed difference: the stack region is found from the descs (a run of
equal ``LayerDesc``s: the same class and arguments), since a stage does
not build the others' entries; the reference compares the built entries'
parameter shapes.
"""

from __future__ import annotations

import inspect
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ....device import resolve_device, seed


class LayerDesc:
    """Deferred layer construction: class + constructor arguments
    (reference class of the same name)."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError(
                f"LayerDesc expects an nn.Module subclass, got "
                f"{layer_func!r}")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self, **build_kw) -> nn.Module:
        """The layer, given those of ``build_kw`` (``device``, ``dtype``,
        ``generator``) its constructor takes."""
        params = inspect.signature(self.layer_func.__init__).parameters
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            build_kw = {k: v for k, v in build_kw.items() if k in params}
        return self.layer_func(*self.inputs, **build_kw, **self.kwargs)

    def signature(self) -> tuple:
        """What makes two descs build the same structure."""
        return (self.layer_func, self.inputs,
                tuple(sorted(self.kwargs.items())))

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A LayerDesc whose built instance is shared across all descs with the
    same ``key`` (tied embeddings)."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedCall:
    """Run-function entry for a SharedLayerDesc occurrence that calls
    ``forward_func`` (or another use of the instance on the same rank)."""

    def __init__(self, layer: nn.Module, forward_func: Optional[Callable],
                 key: str):
        self.layer = layer
        self.forward_func = forward_func
        self.key = key

    def __call__(self, *args):
        if self.forward_func is not None:
            return self.forward_func(self.layer, *args)
        return self.layer(*args)


class SegmentLayers:
    """Compute stage boundaries (reference class of the same name)."""

    def __init__(self, layers_desc: Sequence, num_parts: int,
                 method: str = "uniform"):
        self._layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method
        if len(layers_desc) < num_parts:
            raise ValueError(
                f"cannot split {len(layers_desc)} layers into {num_parts} "
                f"stages")

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(len(self._layers_desc), self.num_parts)
        m = re.match(r"layer:(.+)", self.method)
        if m:
            name = m.group(1)
            matched = [i for i, d in enumerate(self._layers_desc)
                       if self._class_name(d) == name]
            if len(matched) < self.num_parts:
                raise ValueError(
                    f"{len(matched)} layers match {name!r}, need >= "
                    f"{self.num_parts} for {self.num_parts} stages")
            # matched layers spread evenly; a boundary is the first matched
            # layer of each group (stage 0 also takes the prefix)
            per = self.uniform(len(matched), self.num_parts)
            parts = [0]
            for g in range(1, self.num_parts):
                parts.append(matched[per[g]])
            parts.append(len(self._layers_desc))
            return parts
        raise ValueError(f"unknown seg_method {self.method!r}")

    @staticmethod
    def _class_name(desc) -> str:
        if isinstance(desc, LayerDesc):
            return desc.layer_func.__name__
        return type(desc).__name__

    @staticmethod
    def uniform(num_items: int, num_parts: int) -> List[int]:
        splits = np.array_split(np.arange(num_items), num_parts)
        parts = [0]
        for s in splits:
            parts.append(parts[-1] + len(s))
        return parts


def _module_signature(m) -> Optional[tuple]:
    if not isinstance(m, nn.Module):
        return None
    sig = tuple(sorted((n, tuple(p.shape), str(p.dtype))
                       for n, p in m.named_parameters()))
    return sig or None


def _live_pp(topology, num_stages):
    """The hybrid topology whose live pipeline group of ``num_stages`` > 1
    ranks this rank is a stage of: ``topology``, else the current one
    when its pipeline has ``num_stages`` ranks; or None (build
    everything)."""
    from ..base_topology import try_get_hybrid_communicate_group
    hcg = topology if hasattr(topology, "get_stage_id") else None
    if hcg is None:
        hcg = try_get_hybrid_communicate_group()
        if hcg is not None \
                and hcg.get_pipe_parallel_world_size() != num_stages:
            return None
    if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
        return None
    if hcg.get_pipe_parallel_group().process_group is None:
        return None
    if hcg.get_pipe_parallel_world_size() != num_stages:
        raise ValueError(
            f"PipelineLayer of {num_stages} stages on a topology of "
            f"pp = {hcg.get_pipe_parallel_world_size()}")
    return hcg


class PipelineLayer(nn.Module):
    """The segmented model container (reference class of the same name).

    ``layers`` is a list of nn.Module / LayerDesc / SharedLayerDesc /
    plain callables (parameterless transforms). ``run_function`` holds
    this rank's entries in global order (every entry without a live
    pipeline); :meth:`chunk_entries` gives a virtual stage's, which
    ``PipelineTrainStep`` runs."""

    def __init__(self, layers, num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform", recompute_interval: int = 0,
                 recompute_ctx: Optional[Dict] = None,
                 num_virtual_pipeline_stages=None, device=None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        self.recompute_interval = recompute_interval
        # chunks per device for the interleaved schedule (reference arg of
        # the same name)
        self.num_virtual_pipeline_stages = int(num_virtual_pipeline_stages
                                               or 1)
        if num_stages is None and topology is None:
            raise ValueError("need num_stages or topology")
        if num_stages is None:
            num_stages = topology.get_pipe_parallel_world_size()
        self._num_stages = int(num_stages)
        self._layers_desc = list(layers)
        self.segment_parts = SegmentLayers(
            self._layers_desc, self._num_stages, seg_method).do_segment()
        self._seg_method = seg_method
        self._hcg = _live_pp(topology, self._num_stages)
        self._stage = self._hcg.get_stage_id() if self._hcg else 0
        self._virtual_of = self._place()

        dev = resolve_device(device)
        if generator is None:
            generator = seed(0, dev)
        base = int(torch.randint(2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        build_kw = dict(device=dev, dtype=dtype or torch.float32)

        def gen(idx):
            return seed(base + idx, dev)

        # ---- build this rank's entries, in global order
        self.shared_layers: Dict[str, nn.Module] = {}
        self.shared_weight_attrs: Dict[str, str] = {}
        self._shared_owner_idx: Dict[str, int] = {}
        self.shared_aliases: Dict[str, Optional[str]] = {}
        self._copy_sources: Dict[str, str] = {}
        self._entries: List[Tuple[int, Any]] = []
        for idx, d in enumerate(self._layers_desc):
            if isinstance(d, SharedLayerDesc):
                self._shared_owner_idx.setdefault(d.layer_name, idx)
            if not self.holds(idx):
                continue
            if isinstance(d, SharedLayerDesc):
                key = d.layer_name
                if key not in self.shared_layers:
                    # a copy draws as its owner does: the copies start equal
                    layer = d.build_layer(
                        generator=gen(self._shared_owner_idx[key]),
                        **build_kw)
                    self.shared_layers[key] = layer
                    self.shared_weight_attrs[key] = d.shared_weight_attr
                    self.add_module(str(idx), layer)
                    owner = self._shared_owner_idx[key]
                    if owner != idx:
                        for rel, _ in layer.named_parameters():
                            name = f"{idx}.{rel}"
                            self._copy_sources[name] = f"{owner}.{rel}"
                            self.shared_aliases[name] = (
                                f"{owner}.{rel}"
                                if rel == d.shared_weight_attr else None)
                    if d.forward_func is None:
                        self._entries.append((idx, str(idx)))
                        continue
                self._entries.append((idx, _SharedCall(
                    self.shared_layers[key], d.forward_func, key)))
            elif isinstance(d, LayerDesc):
                self.add_module(str(idx), d.build_layer(generator=gen(idx),
                                                        **build_kw))
                self._entries.append((idx, str(idx)))
            elif isinstance(d, nn.Module):
                self.add_module(str(idx), d)
                self._entries.append((idx, str(idx)))
            elif callable(d):
                self._entries.append((idx, d))
            else:
                raise TypeError(f"unsupported pipeline entry {d!r}")
        self.shared_groups = self._shared_comm()

    # ------------------------------------------------------------ placement
    def _signature(self, idx) -> Optional[tuple]:
        d = self._layers_desc[idx]
        if isinstance(d, SharedLayerDesc):
            return None
        if isinstance(d, LayerDesc):
            return ("desc",) + d.signature()
        return _module_signature(d)

    def stack_region(self) -> Tuple[int, int]:
        """Maximal run [start, end) of identically-built entries: the
        blocks the stages split. Entries before it are the prefix (stage
        0), after it the suffix (stage S - 1)."""
        sigs = [self._signature(i) for i in range(len(self._layers_desc))]
        best = (0, 0)
        i, n = 0, len(sigs)
        while i < n:
            if sigs[i] is None:
                i += 1
                continue
            j = i + 1
            while j < n and sigs[j] == sigs[i]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        return best

    def stage_block_counts(self) -> List[int]:
        """Per-stage count of stack-region blocks: ``"uniform"`` spreads
        the block region evenly (the prefix and suffix carry no load
        there); ``"layer:<Class>"`` intersects ``segment_parts`` with the
        region (reference semantics)."""
        start, end = self.stack_region()
        if self._seg_method == "uniform":
            return [len(s) for s in np.array_split(np.arange(end - start),
                                                   self._num_stages)]
        counts = []
        for s in range(self._num_stages):
            a, b = self.segment_parts[s], self.segment_parts[s + 1]
            counts.append(max(0, min(b, end) - max(a, start)))
        return counts

    def _place(self) -> List[int]:
        """The virtual stage (``v S + s``) of every entry."""
        S, V = self._num_stages, self.num_virtual_pipeline_stages
        start, end = self.stack_region()
        n = len(self._layers_desc)
        out = [0] * n
        if V == 1:
            bounds = np.concatenate(
                [[start], start + np.cumsum(self.stage_block_counts())])
            for s in range(S):
                for i in range(int(bounds[s]), int(bounds[s + 1])):
                    out[i] = s
            for i in range(end, n):
                out[i] = S - 1
            return out
        L = (end - start) // (S * V)
        for c in range(S * V):
            for i in range(start + c * L, start + (c + 1) * L):
                out[i] = c
        for i in range(start + S * V * L, n):
            out[i] = S * V - 1
        return out

    def virtual_stage_of(self, idx: int) -> int:
        return self._virtual_of[idx]

    def holds(self, idx: int) -> bool:
        """Whether this rank builds entry ``idx`` (every entry without a
        live pipeline)."""
        return (self._hcg is None
                or self._virtual_of[idx] % self._num_stages == self._stage)

    def _shared_comm(self) -> Dict[str, Any]:
        """For each shared key used on several stages, this rank's group
        of its copies. Collective: every rank makes every group, in one
        order."""
        if self._hcg is None:
            return {}
        from ...communication.group import new_group
        S = self._num_stages
        uses: Dict[str, set] = {}
        for idx, d in enumerate(self._layers_desc):
            if isinstance(d, SharedLayerDesc):
                uses.setdefault(d.layer_name, set()).add(
                    self._virtual_of[idx] % S)
        groups = {}
        for key, stages in uses.items():
            if len(stages) < 2:
                continue
            for ranks in self._hcg.topology().get_comm_list("pipe"):
                g = new_group([ranks[s] for s in sorted(stages)])
                if g.is_member():
                    groups[key] = g
        return groups

    # ---------------------------------------------------------------- entries
    def _resolve(self, ref):
        return self._modules[ref] if isinstance(ref, str) else ref

    @property
    def run_function(self) -> List[Any]:
        """This rank's entries in global order (a module swapped for its
        tensor-parallel shard is read at call time)."""
        return [self._resolve(ref) for _, ref in self._entries]

    def local_indices(self) -> List[int]:
        return [idx for idx, _ in self._entries]

    def chunk_entries(self, c: int) -> List[Tuple[int, Any]]:
        """``(global index, callable)`` of virtual stage ``c``'s entries
        (every entry at one virtual stage without a live pipeline)."""
        if self._hcg is None and self._num_stages * \
                self.num_virtual_pipeline_stages == 1:
            return [(i, self._resolve(r)) for i, r in self._entries]
        out = [(i, self._resolve(r)) for i, r in self._entries
               if self._virtual_of[i] == c]
        if self._hcg is not None and c % self._num_stages != self._stage:
            raise ValueError(f"virtual stage {c} is not on stage "
                             f"{self._stage}")
        return out

    def is_block(self, idx: int) -> bool:
        start, end = self.stack_region()
        return start <= idx < end

    # ---------------------------------------------------------------- eager
    def forward(self, *args, chunk_id: Optional[int] = None):
        """This rank's entries on ``args`` (those of its virtual chunk
        ``chunk_id`` when given); without a live pipeline, the whole
        stack. Blocks are checkpointed every ``recompute_interval`` while
        gradients are on."""
        if chunk_id is None:
            entries = [(i, self._resolve(r)) for i, r in self._entries]
        else:
            entries = self.chunk_entries(
                chunk_id * self._num_stages + self._stage)
        return self.run_entries(entries, args,
                                remat=self.recompute_interval > 0)

    def run_entries(self, entries, args, remat: bool = False):
        """``entries`` applied in order to ``args`` (a tuple is spread into
        the next entry); under ``remat`` each run of
        ``max(1, recompute_interval)`` blocks is one checkpoint."""
        out = args if isinstance(args, tuple) else (args,)
        every = max(1, int(self.recompute_interval))
        seg: List[Any] = []

        def flush(out):
            if not seg:
                return out
            fns = list(seg)
            seg.clear()

            def run(*xs):
                for f in fns:
                    xs = f(*xs)
                    xs = xs if isinstance(xs, tuple) else (xs,)
                return xs[0] if len(xs) == 1 else xs

            if remat and torch.is_grad_enabled():
                o = checkpoint(run, *out, use_reentrant=False)
            else:
                o = run(*out)
            return o if isinstance(o, tuple) else (o,)

        for idx, fn in entries:
            if remat and self.is_block(idx):
                seg.append(fn)
                if len(seg) == every:
                    out = flush(out)
                continue
            out = flush(out)
            o = fn(*out)
            out = o if isinstance(o, tuple) else (o,)
        out = flush(out)
        return out[0] if len(out) == 1 else out

    # ------------------------------------------------------------- metadata
    def get_num_stages(self) -> int:
        return self._num_stages

    def get_stage_range(self, stage: int):
        if self.num_virtual_pipeline_stages > 1:
            raise ValueError(
                "get_stage_range() assumes one contiguous range per stage; "
                "with num_virtual_pipeline_stages > 1 device placement is "
                "interleaved — use get_stage_layer_indices(stage) instead")
        return self.segment_parts[stage], self.segment_parts[stage + 1]

    def get_stage_layer_indices(self, stage: int) -> List[int]:
        """Entry indices stage ``stage`` holds: the placement the
        reference executes (its prefix on stage 0, its suffix on the
        last)."""
        S = self._num_stages
        return [i for i in range(len(self._layers_desc))
                if self._virtual_of[i] % S == stage]

    def get_stage_layers(self, stage: int):
        if self._hcg is not None and stage != self._stage:
            raise ValueError(f"stage {stage}'s layers live on another rank "
                             f"(this is stage {self._stage})")
        held = dict((i, self._resolve(r)) for i, r in self._entries)
        return [held[i] for i in self.get_stage_layer_indices(stage)]

    def describe(self) -> str:
        lines = []
        for s in range(self._num_stages):
            a, b = self.get_stage_range(s)
            names = [SegmentLayers._class_name(d)
                     for d in self._layers_desc[a:b]]
            lines.append(f"stage {s}: layers [{a}, {b}) = {names}")
        return "\n".join(lines)
