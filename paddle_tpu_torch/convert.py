"""Carry named weights and optimizer state from numpy into the port.

The JAX model's ``raw_state()`` gives name -> array dicts; through
``np.asarray`` they become numpy arrays, and bf16 ones arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses. Those go
through float32 and are cast on the way in. :func:`load_state` copies such
a dict into a module's parameters and, for a weight-quantized model, its
buffers (``QuantizedLinear``'s int8 ``quant_weight`` and f32
``weight_scale``: ``raw_state()`` returns ``(params, buffers)``), each cast
to the dtype of the tensor it lands in.

:func:`optimizer_state_from_jax` turns the JAX optimizer's state into what
the port's ``Optimizer.set_state_dict`` (and ``TrainStep.set_state_dict``
under ``"@opt_state"``) takes, so a run resumes where the JAX one stopped.

:func:`shard_state` cuts whole parameters (the JAX model's, say) into one
rank's shards by their specs (a tuple of mesh-axis names or None a
dimension, or a tuple of names for a dimension they cut together, as a
``PartitionSpec``, e.g. ``annotate_llama_tp``'s ``dist_attr`` or a ZeRO
spec from ``extend_spec_with_sharding``) and the rank's mesh coordinates;
:func:`gather_state` puts every rank's shards back together.

Pipelines: :func:`pipe_state` takes the JAX ``PipelineLayer``'s named
parameters (``"{idx}.{rel}"``, a tied weight at its first use) into one
rank's stage entries, a tied copy from the owner's weight, each cut by mp
where the stage holds a shard; :func:`gather_pipe_state` puts the stages
back into that flat dict, holding the data-parallel replicas and the tied
copies equal bit for bit. :func:`pipe_name_map` maps ``LlamaForCausalLM``
/ ``GPTForCausalLM`` parameter names onto their pipe's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr.astype(np.float32))).to(torch.bfloat16)
    # a copy: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(arr, order="C"))


def state_from_numpy(named: Mapping[str, np.ndarray],
                     device: DeviceLike = None,
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` (default: the card), cast to ``dtype``
    when given, else kept in the source dtype."""
    dev = resolve_device(device)
    out = {}
    for name, arr in named.items():
        t = _to_torch(arr)
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


@torch.no_grad()
def load_state(module: torch.nn.Module, params: Mapping[str, np.ndarray],
               buffers: Optional[Mapping[str, np.ndarray]] = None) -> None:
    """Copy ``params`` (and ``buffers``; None entries skipped) into
    ``module``'s parameters and buffers of the same names, each cast to
    the dtype of the tensor it lands in. With ``buffers`` the two dicts
    together must name exactly the module's parameters and buffers (the
    JAX package files frozen parameters under buffers), else exactly its
    parameters."""
    named = {k: v for k, v in {**dict(params), **dict(buffers or {})}.items()
             if v is not None}
    targets = dict(module.named_parameters())
    if buffers is not None:
        targets.update((k, b) for k, b in module.named_buffers()
                       if b is not None)
    missing = sorted(set(targets) - set(named))
    extra = sorted(set(named) - set(targets))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, arr in named.items():
        dst = targets[name]
        t = _to_torch(arr)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(t.to(device=dst.device, dtype=dst.dtype))


def _plain(value: Any) -> Any:
    """A scheduler's state with nested schedulers as their own state
    dicts (the port's ``LRScheduler.set_state_dict`` descends into
    them)."""
    if hasattr(value, "state_dict") and callable(value.state_dict):
        return {k: _plain(v) for k, v in value.state_dict().items()}
    return value


def optimizer_state_from_jax(state: Mapping[str, Any],
                             names: Optional[Mapping[str, str]] = None,
                             lr_state: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, Any]:
    """The port's optimizer state from the JAX optimizer's.

    ``state`` is the ``"@opt_state"`` of the JAX ``TrainStep.state_dict()``
    (``{"slots": {name: {slot: array}}, "t": step, "master": {name: array}
    or None}``), or the eager optimizer's in that shape:
    ``{"slots": opt._slots, "master": opt._master, "t": opt._step_count}``.
    ``names`` maps a JAX parameter name to the port's where they differ.
    ``lr_state`` is the JAX scheduler's ``state_dict()``. Returns
    ``{"<name>_<slot>_0": array, "<name>_fp32_master_0": array, "@step":
    t}`` with numpy arrays (bf16 ones as float32), plus ``"LR_Scheduler"``
    when ``lr_state`` is given."""
    names = dict(names or {})
    out: Dict[str, Any] = {}
    for jname, slots in (state.get("slots") or {}).items():
        name = names.get(jname, jname)
        for key, arr in (slots.items() if isinstance(slots, Mapping)
                         else ()):
            out[f"{name}_{key}_0"] = _to_torch(arr).float().numpy()
    for jname, arr in (state.get("master") or {}).items():
        out[f"{names.get(jname, jname)}_fp32_master_0"] = (
            _to_torch(arr).float().numpy())
    out["@step"] = int(np.asarray(state.get("t", 0)))
    if lr_state is not None:
        out["LR_Scheduler"] = {k: _plain(v) for k, v in lr_state.items()}
    return out


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry: none, one, or a tuple of them
    (the dimension cut by their product, the first major)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_slices(shape: Sequence[int], spec: Optional[Sequence],
                 coords: Mapping[str, int], sizes: Mapping[str, int]
                 ) -> Tuple[slice, ...]:
    """The index of one rank's shard of a ``shape`` parameter: along each
    dimension whose ``spec`` entry names mesh axes, one of the product of
    their ``sizes`` equal parts, numbered by the rank's ``coords`` with the
    first axis major (``("mp", "sharding")``: mp's part, then sharding's
    part of it, the order of a ``PartitionSpec`` tuple entry); other
    dimensions whole."""
    spec = tuple(spec or ())
    out = []
    for d, n in enumerate(shape):
        parts, i = 1, 0
        for axis in entry_axes(spec[d] if d < len(spec) else None):
            parts *= sizes.get(axis, 1)
            i = i * sizes.get(axis, 1) + coords.get(axis, 0)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} not divisible by "
                             f"{spec[d]}={parts}")
        step = n // parts
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def shard_state(named: Mapping[str, np.ndarray],
                specs: Mapping[str, Optional[Sequence]],
                coords: Mapping[str, int], sizes: Mapping[str, int]
                ) -> Dict[str, np.ndarray]:
    """Each array of ``named`` cut to the shard of the rank at ``coords``
    (axis -> coordinate) on a mesh of ``sizes`` (axis -> size); a name
    without a spec stays whole. Any axis cuts alike: an MoE's expert
    stacks under expert parallelism (``("dp", None, None)``) are cut over
    the data axis to the rank's experts. bf16 arrays arrive as
    float32."""
    out = {}
    for name, arr in named.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        idx = shard_slices(a.shape, specs.get(name), coords, sizes)
        out[name] = np.ascontiguousarray(a[idx])
    return out


def gather_state(shards: Sequence[Mapping[str, np.ndarray]],
                 specs: Mapping[str, Optional[Sequence]],
                 coords: Sequence[Mapping[str, int]],
                 sizes: Mapping[str, int]) -> Dict[str, np.ndarray]:
    """Whole arrays from every rank's shards (``shards[i]`` held by the
    rank at ``coords[i]``): each shard written into its slice. Ranks that
    hold the same slice (replicas over another axis) must agree bit for
    bit, else ``ValueError``."""
    out: Dict[str, np.ndarray] = {}
    for name in shards[0]:
        whole_shape = list(np.shape(shards[0][name]))
        for d, entry in enumerate(tuple(specs.get(name) or ())):
            for axis in entry_axes(entry):
                whole_shape[d] *= sizes.get(axis, 1)
        whole = np.zeros(whole_shape, np.asarray(shards[0][name]).dtype)
        seen = {}
        for shard, c in zip(shards, coords):
            idx = shard_slices(whole_shape, specs.get(name), c, sizes)
            key = tuple((s.start, s.stop) for s in idx)
            if key in seen and not np.array_equal(seen[key], shard[name]):
                raise ValueError(f"{name}: replicas of slice {key} differ")
            seen[key] = shard[name]
            whole[idx] = shard[name]
        out[name] = whole
    return out


# -------------------------------------------------------------- pipelines
def pipe_name_map(model) -> Dict[str, str]:
    """``LlamaForCausalLM`` / ``GPTForCausalLM`` parameter name -> the name
    in its pipe (``LlamaForCausalLMPipe`` / ``GPTForCausalLMPipe`` of the
    same config): the embedding entry 0 (``llama.embed_tokens.weight`` ->
    ``0.embed_tokens.weight``; GPT's ``wte`` / ``wpe``), layer i entry
    i + 1, the final norm entry n + 1 and the head entry n + 2."""
    n = model.config.num_hidden_layers
    out = {}
    for name, _ in model.named_parameters():
        m = re.fullmatch(r"(?:llama\.layers|gpt\.h)\.(\d+)\.(.+)", name)
        if m:
            out[name] = f"{int(m.group(1)) + 1}.{m.group(2)}"
        elif name.startswith(("llama.embed_tokens.", "gpt.wte.",
                               "gpt.wpe.")):
            out[name] = "0." + name.split(".", 1)[1]
        elif name.startswith(("llama.norm.", "gpt.ln_f.")):
            out[name] = f"{n + 1}." + name.rsplit(".", 1)[1]
        elif name.startswith("lm_head."):
            out[name] = f"{n + 2}." + name.split(".", 1)[1]
        else:
            raise KeyError(f"{name}: no pipe entry")
    return out


def _pipe_coords(pipe) -> Tuple[Dict[str, int], Dict[str, int]]:
    hcg = pipe._hcg
    if hcg is None:
        from .distributed.fleet.base_topology import \
            try_get_hybrid_communicate_group
        hcg = try_get_hybrid_communicate_group()
    if hcg is None:
        return {}, {}
    return ({"dp": hcg.get_data_parallel_rank(),
             "sharding": hcg.get_sharding_parallel_rank(),
             "mp": hcg.get_model_parallel_rank()},
            {"dp": hcg.get_data_parallel_world_size(),
             "sharding": hcg.get_sharding_parallel_world_size(),
             "mp": hcg.get_model_parallel_world_size()})


def pipe_state(named: Mapping[str, np.ndarray], pipe,
               coords: Optional[Mapping[str, int]] = None,
               sizes: Optional[Mapping[str, int]] = None
               ) -> Dict[str, np.ndarray]:
    """This rank's stage entries of ``pipe`` from ``named`` (the reference
    ``PipelineLayer``'s parameters by ``"{idx}.{rel}"``): a tied copy
    from its owner's entry; a parameter the stage holds as a shard (its
    ``dist_attr`` spec) cut at ``coords`` on a mesh of ``sizes`` (default:
    the topology's mp, dp and sharding coordinates). bf16 arrives as
    float32; :func:`load_state` takes the result."""
    if coords is None or sizes is None:
        coords, sizes = _pipe_coords(pipe)
    out = {}
    for name, p in pipe.named_parameters():
        a = np.asarray(named[pipe._copy_sources.get(name, name)])
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        if tuple(a.shape) != tuple(p.shape):
            a = a[shard_slices(a.shape, getattr(p, "dist_attr", None),
                               coords, sizes)]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: {a.shape} does not cut to "
                             f"{tuple(p.shape)}")
        out[name] = np.ascontiguousarray(a)
    return out


def gather_pipe_state(shards: Sequence[Mapping[str, np.ndarray]],
                      specs: Mapping[str, Optional[Sequence]],
                      coords: Sequence[Mapping[str, int]],
                      sizes: Mapping[str, int],
                      aliases: Optional[Mapping[str, Optional[str]]] = None
                      ) -> Dict[str, np.ndarray]:
    """The reference's flat ``"{idx}.{rel}"`` dict from every rank's stage
    entries (``shards[i]`` held by the rank at ``coords[i]``, with its
    ``"pp"`` coordinate): each stage's shards gathered over the other axes
    (:func:`gather_state`: replicas equal bit for bit), then the stages
    merged. ``aliases`` (the ranks' ``PipelineLayer.shared_aliases``)
    names each tied copy's owner entry, which the copy must equal bit for
    bit; a copy's parameters that alias None are dropped."""
    aliases = dict(aliases or {})
    others = {k: v for k, v in sizes.items() if k != "pp"}
    out: Dict[str, np.ndarray] = {}
    copies: Dict[str, np.ndarray] = {}
    for stage in range(sizes.get("pp", 1)):
        held = [i for i, c in enumerate(coords) if c.get("pp", 0) == stage]
        whole = gather_state([shards[i] for i in held], specs,
                             [coords[i] for i in held], others)
        for name, arr in whole.items():
            if name in aliases:
                if aliases[name] is not None:
                    copies[name] = arr
            else:
                out[name] = arr
    for name, arr in copies.items():
        owner = aliases[name]
        if not np.array_equal(out[owner], arr):
            raise ValueError(f"tied copy {name} differs from {owner}")
    return out
