"""Megatron tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/mp_layers.py``).

Each rank holds its own shard of a layer's logical weight and runs the
collectives of :mod:`...layers.mpu.mp_ops` around its local product: the
reference's manual-axis branch (``_manual_axis``), not its GSPMD one, which
keeps the logical weight and lets XLA insert the collectives.

  VocabParallelEmbedding  table (vocab / n, dim): masked local lookup, sum
  ColumnParallelLinear    weight (in, out / n), bias (out / n);
                          identity in (all-reduce of dx), all-gather out
                          unless ``gather_output=False``
  RowParallelLinear       weight (in / n, out), bias (out) replicated;
                          my slice in unless ``input_is_parallel``, the
                          partial products all-reduced, then the bias once
  ParallelCrossEntropy    softmax cross entropy over vocab-sharded logits:
                          max, sum of exp and the label's logit all-reduced

The degree comes from ``mp_group``, else the hybrid topology's ``mp``
group; with one rank the layers are their serial selves (the same ops as
``nn.Linear`` / ``nn.Embedding``). A layer's logical weight is drawn whole
from ``generator`` and cut to this rank's shard, so every rank holds a
shard of the same weight. The reference's ``is_distributed``,
``split_axis`` and ``dist_attr`` (a tuple of axis names or None, as its
``PartitionSpec``) ride on each parameter.

:func:`parallel_fused_linear_cross_entropy` is the chunked LM loss over a
vocab-sharded head and, given a data-parallel group, the mean over the
whole global batch's tokens. :func:`shard_layers` swaps a serial model's
annotated layers for these, in place: ``TrainStep(mesh=...)`` calls it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .....amp.auto_cast import amp_cast
from .....device import DeviceLike, resolve_device
from .....incubate.nn.functional import _FusedLinearCrossEntropy
from .....nn.initializer import Normal
from .....nn.layers.common import Embedding, Linear
from ....communication import collectives as C
from ....communication.group import Group, ReduceOp
from ...layers.mpu.mp_ops import (_c_concat, _c_identity, _c_split,
                                  _mp_allreduce, _parallel_embedding,
                                  mp_group as _resolve_group)


def _degree(group: Optional[Group]) -> Tuple[int, int]:
    """(ranks, this rank) of an mp group; (1, 0) without one."""
    return (1, 0) if group is None else (group.nranks, group.rank)


def _check_divisible(size: int, n: int, what: str) -> None:
    if size % n:
        raise ValueError(f"{what} {size} not divisible by mp degree {n}")


def _shard_of(full: torch.Tensor, axis: int, n: int, rank: int):
    return full.chunk(n, dim=axis)[rank].contiguous() if n > 1 else full


def is_sharded(p: torch.Tensor) -> bool:
    """Whether ``p`` is a tensor-parallel shard (the reference's
    ``is_distributed``; ``torch.Tensor`` has a method of that name, which
    an unmarked parameter still shows)."""
    return getattr(p, "is_distributed", False) is True


def _mark(p: nn.Parameter, n: int, split_axis: Optional[int], spec):
    p.is_distributed = n > 1 and split_axis is not None
    p.split_axis = split_axis
    p.dist_attr = spec
    return p


def _refuse_attr(attr) -> None:
    if attr is not None:
        raise NotImplementedError(
            "weight_attr is not ported: the port's layers take std= and "
            "generator=")


class _Parallel(nn.Module):
    """What the three layers share: the group, its degree and this rank."""

    def _bind(self, mp_group: Optional[Group]) -> None:
        self.mp_group = _resolve_group(mp_group)
        self.world_size, self.rank = _degree(self.mp_group)


class VocabParallelEmbedding(_Parallel):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *,
                 std: Optional[float] = None, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _refuse_attr(weight_attr)
        self._bind(mp_group)
        _check_divisible(num_embeddings, self.world_size, "vocab size")
        self._num_embeddings, self._embedding_dim = (num_embeddings,
                                                     embedding_dim)
        if std is None:    # the reference's XavierNormal
            std = math.sqrt(2.0 / (num_embeddings + embedding_dim))
        full = Normal(0.0, std)((num_embeddings, embedding_dim),
                                resolve_device(device),
                                dtype or torch.float32, generator)
        self.weight = _mark(nn.Parameter(_shard_of(
            full, 0, self.world_size, self.rank)), self.world_size, 0,
            ("mp", None))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.world_size == 1:
            return self.weight[ids]
        return _parallel_embedding(ids, self.weight, self.mp_group)

    def extra_repr(self):
        return (f"{self._num_embeddings}, {self._embedding_dim}, "
                f"mp={self.world_size}")


class ColumnParallelLinear(_Parallel):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, fuse_matmul_bias: bool = False,
                 mp_group=None, name=None, *, std: Optional[float] = None,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _refuse_attr(weight_attr)
        self._bind(mp_group)
        _check_divisible(out_features, self.world_size, "out_features")
        self._in_features, self._out_features = in_features, out_features
        self.gather_output = gather_output
        dev, dtype = resolve_device(device), dtype or torch.float32
        if std is None:
            std = math.sqrt(2.0 / (in_features + out_features))
        full = Normal(0.0, std)((in_features, out_features), dev, dtype,
                                generator)
        n, r = self.world_size, self.rank
        self.weight = _mark(nn.Parameter(_shard_of(full, 1, n, r)), n, 1,
                            (None, "mp"))
        self.bias = (_mark(nn.Parameter(torch.zeros(
            out_features // n, device=dev, dtype=dtype)), n, 0, ("mp",))
            if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = amp_cast("linear", _c_identity(x, self.mp_group),
                           self.weight, self.bias)
        y = x @ w
        y = y if b is None else y + b
        return _c_concat(y, self.mp_group) if self.gather_output else y

    def extra_repr(self):
        return (f"in={self._in_features}, out={self._out_features}, "
                f"mp={self.world_size}, gather_output={self.gather_output}")


class RowParallelLinear(_Parallel):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 *, std: Optional[float] = None, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _refuse_attr(weight_attr)
        self._bind(mp_group)
        _check_divisible(in_features, self.world_size, "in_features")
        self._in_features, self._out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        dev, dtype = resolve_device(device), dtype or torch.float32
        if std is None:
            std = math.sqrt(2.0 / (in_features + out_features))
        full = Normal(0.0, std)((in_features, out_features), dev, dtype,
                                generator)
        n, r = self.world_size, self.rank
        self.weight = _mark(nn.Parameter(_shard_of(full, 0, n, r)), n, 0,
                            ("mp", None))
        self.bias = (_mark(nn.Parameter(torch.zeros(
            out_features, device=dev, dtype=dtype)), n, None, (None,))
            if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = _c_split(x, self.mp_group, -1)
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = _mp_allreduce(x @ w, self.mp_group)
        return y if b is None else y + b

    def extra_repr(self):
        return (f"in={self._in_features}, out={self._out_features}, "
                f"mp={self.world_size}, "
                f"input_is_parallel={self.input_is_parallel}")


def _vocab_parallel_stats(logits: torch.Tensor, local: torch.Tensor,
                          group: Group):
    """Each row's log-sum-exp over the whole vocabulary and its label's
    logit (0 for a label on no rank), from this rank's f32 logits
    ``(T, V / n)`` and the labels less this shard's first id: the max
    all-reduced, then the sum of exp and the label's logit in one
    all-reduce."""
    vocab = logits.shape[1]
    m = logits.max(dim=-1).values.contiguous()
    C.all_reduce(m, op=ReduceOp.MAX, group=group)
    mine = (local >= 0) & (local < vocab)
    gold = logits.gather(1, local.clamp(0, vocab - 1)[:, None])[:, 0]
    sums = torch.stack([torch.exp(logits - m[:, None]).sum(-1),
                        torch.where(mine, gold, torch.zeros_like(gold))])
    C.all_reduce(sums, group=group)
    return m + torch.log(sums[0]), sums[1], mine


class _ParallelCE(torch.autograd.Function):
    """Per-token softmax cross entropy over vocab-sharded logits, the
    reference's manual branch: the backward is ``(softmax - onehot) * g``
    on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        shape = logits.shape
        l32 = logits.reshape(-1, shape[-1]).float()
        lab = label.reshape(-1).long()
        n, r = _degree(group)
        vocab = l32.shape[1]
        if n == 1:
            lse = torch.logsumexp(l32, dim=-1)
            mine = (lab >= 0) & (lab < vocab)
            gold = l32.gather(1, lab.clamp(0, vocab - 1)[:, None])[:, 0]
        else:
            lse, gold, mine = _vocab_parallel_stats(l32, lab - r * vocab,
                                                    group)
        loss = lse - gold
        invalid = (lab < 0) | (lab >= vocab * n)
        loss = torch.where(invalid, torch.full_like(loss, float("nan")),
                           loss)
        keep = lab != ignore_index
        loss = torch.where(keep, loss, torch.zeros_like(loss))
        ctx.save_for_backward(l32, lab, lse, mine & ~invalid & keep,
                              keep & ~invalid)
        ctx.shape, ctx.dtype, ctx.r = shape, logits.dtype, r * vocab
        return loss.reshape(*shape[:-1], 1)

    @staticmethod
    def backward(ctx, g):
        l32, lab, lse, hit, active = ctx.saved_tensors
        vocab = l32.shape[1]
        p = torch.exp(l32 - lse[:, None])
        local = (lab - ctx.r).clamp(0, vocab - 1)
        p.scatter_add_(1, local[:, None], -hit.float()[:, None])
        ct = g.reshape(-1).float() * active.float()
        return (p * ct[:, None]).to(ctx.dtype).reshape(ctx.shape), None, \
            None, None


class ParallelCrossEntropy(_Parallel):
    """Softmax cross entropy of vocab-sharded logits ``(..., V / n)``
    against global label ids: the per-token loss ``(..., 1)`` in f32, 0 at
    ``ignore_index``, NaN at a label outside the vocabulary."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self._bind(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input: torch.Tensor, label: torch.Tensor):
        return _ParallelCE.apply(input, label, self.mp_group,
                                 self.ignore_index)


def parallel_matmul(x: torch.Tensor, weight: torch.Tensor,
                    transpose_y: bool = True, mp_group=None):
    """The tied head's product over a vocab-sharded table: the identity in
    (all-reduce of dx), then the local product (vocab-sharded logits)."""
    x = _c_identity(x, _resolve_group(mp_group))
    return x @ (weight.t() if transpose_y else weight)


def parallel_fused_linear_cross_entropy(
        hidden: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
        mp_group: Optional[Group] = None, dp_group: Optional[Group] = None,
        transpose_y: bool = False, ignore_index: int = -100,
        chunk_tokens: int = 1024) -> torch.Tensor:
    """``incubate.nn.functional.fused_linear_cross_entropy`` over this
    rank's vocabulary shard of the head (``(H, V / n)``, or ``(V / n, H)``
    with ``transpose_y``): each chunk's max, sum of exp and label logit are
    all-reduced over ``mp_group``, so no rank gathers the logits. With
    ``dp_group`` the unmasked tokens are counted over the data-parallel
    ranks and the result is this rank's share of the mean over the global
    batch, times the group's size: averaged over ``dp_group`` (as the data
    parallel gradients are) it is the global mean, whatever the ranks'
    counts of ignored labels. With one rank in each group it is
    ``fused_linear_cross_entropy``'s value, bit for bit."""
    mp = _resolve_group(mp_group)
    n, _ = _degree(mp)
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = labels.reshape(-1).long()
    l2 = torch.where(l2 == ignore_index, torch.full_like(l2, -1), l2)
    count = None
    if dp_group is not None:
        count = (l2 >= 0).sum()
        C.all_reduce(count, group=dp_group)
        count = count.clamp_min(1).to(torch.float32)
    loss = _FusedLinearCrossEntropy.apply(
        _c_identity(h2, mp), weight, l2, bool(transpose_y),
        max(1, int(chunk_tokens)), mp if n > 1 else None, count)
    if dp_group is not None and dp_group.nranks > 1:
        loss = loss * dp_group.nranks
    return loss


# ------------------------------------------------------------ the swap
def _adopt(cls, serial: nn.Module, group: Optional[Group], axis: int,
           spec, **attrs):
    """A ``cls`` layer holding ``serial``'s own parameters, each cut in
    place to this rank's shard along ``axis`` (the bias of a column layer
    too; a row layer's bias stays whole). The parameter objects are kept,
    so an optimizer built over the serial model still holds them."""
    layer = cls.__new__(cls)
    nn.Module.__init__(layer)
    layer._bind(group)
    n, r = layer.world_size, layer.rank
    for k, v in attrs.items():
        setattr(layer, k, v)
    w = serial.weight
    _check_divisible(w.shape[axis], n, f"dim {axis} of {cls.__name__}")
    with torch.no_grad():
        w.data = _shard_of(w.data, axis, n, r)
    layer.weight = _mark(w, n, axis, spec)
    bias = getattr(serial, "bias", None)
    if bias is not None:
        with torch.no_grad():
            if axis == 1:
                bias.data = _shard_of(bias.data, 0, n, r)
        _mark(bias, n, 0 if axis == 1 else None,
              ("mp",) if axis == 1 else (None,))
    if cls is not VocabParallelEmbedding:
        layer.bias = bias
    return layer


def shard_layers(model: nn.Module, spec_of: Callable[[str, nn.Parameter],
                                                     Optional[tuple]],
                 mp_axis: str, group: Optional[Group]) -> Dict[str, str]:
    """Swap, in place, every ``Linear`` and ``Embedding`` of ``model``
    whose weight's spec names ``mp_axis``: ``(None, mp)`` becomes a
    :class:`ColumnParallelLinear` (its output left sharded, Megatron's
    pairing with the row layer after it), ``(mp, None)`` a
    :class:`RowParallelLinear` taking a parallel input, or a
    :class:`VocabParallelEmbedding`. A module with ``num_heads`` (and
    ``num_kv_heads``) whose projections were swapped then counts this
    rank's heads. A column layer's bias is cut with its weight (its spec
    may say so, ``(mp,)``, as the reference's must); the parameters of a
    Megatron layer built as one are left as they are. Returns
    ``{parameter name: kind}`` of what was swapped; a parameter sharded
    any other way raises."""
    n, _ = _degree(group)
    names = {id(p): k for k, p in model.named_parameters()}
    swapped: Dict[str, str] = {}
    column_biases = set()
    for owner in list(model.modules()):
        cut = False
        for child_name, child in list(owner.named_children()):
            if not isinstance(child, (Linear, Embedding)):
                continue
            pname = names[id(child.weight)]
            spec = tuple(spec_of(pname, child.weight) or ())
            if mp_axis not in spec:
                continue
            if isinstance(child, Embedding) and spec == (mp_axis, None):
                new = _adopt(VocabParallelEmbedding, child, group, 0, spec,
                             _num_embeddings=child.weight.shape[0],
                             _embedding_dim=child.weight.shape[1])
                kind = "vocab"
            elif isinstance(child, Linear) and spec == (None, mp_axis):
                new = _adopt(ColumnParallelLinear, child, group, 1, spec,
                             _in_features=child.in_features,
                             _out_features=child.out_features,
                             gather_output=False)
                kind = "column"
            elif isinstance(child, Linear) and spec == (mp_axis, None):
                new = _adopt(RowParallelLinear, child, group, 0, spec,
                             _in_features=child.in_features,
                             _out_features=child.out_features,
                             input_is_parallel=True)
                kind = "row"
            else:
                raise NotImplementedError(
                    f"{pname}: spec {spec} on a {type(child).__name__}")
            setattr(owner, child_name, new)
            swapped[pname] = kind
            if kind == "column" and child.bias is not None:
                column_biases.add(names[id(child.bias)])
            cut = cut or kind == "column"
        if cut and n > 1 and hasattr(owner, "num_heads"):
            for attr in ("num_heads", "num_kv_heads"):
                if hasattr(owner, attr):
                    _check_divisible(getattr(owner, attr), n, attr)
                    setattr(owner, attr, getattr(owner, attr) // n)
    for pname, p in model.named_parameters():
        spec = tuple(spec_of(pname, p) or ())
        # a Megatron layer's own parameter (split_axis set) is a shard
        # already
        if mp_axis in spec and pname not in swapped and not (
                pname in column_biases and spec == (mp_axis,)) \
                and getattr(p, "split_axis", None) is None:
            raise NotImplementedError(
                f"{pname}: only Linear and Embedding weights shard over "
                f"{mp_axis!r} in the port")
    return swapped
