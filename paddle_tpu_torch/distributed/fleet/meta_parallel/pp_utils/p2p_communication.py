"""Stage-to-stage transfers of the pipeline (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_utils/p2p_communication.py``).

The reference's pipelined step is one SPMD program whose stage shift is an
XLA collective-permute, so its shapes are static and this module is only
its eager surface. Here each stage is a process and activations and their
gradients really move between ranks over the hybrid topology's ``pp``
group, on :mod:`...communication.p2p`, as in upstream Paddle:

- :class:`SendRecvMeta`: the receiver must allocate before it receives, so
  the first forward transfer sends the activation's shape and dtype first
  (one int64 message of 16, ``[ndim, dtype code, *shape]``).
  Later transfers reuse it; a gradient going back has the shape of the
  activation that came forward, which both ends know.
- ``send_forward`` / ``recv_forward`` / ``send_backward`` /
  ``recv_backward``, and the pairs a 1F1B steady state needs,
  ``send_forward_recv_backward`` and ``send_backward_recv_forward``, issued
  as one ``batch_isend_irecv`` (a blocking send and a blocking receive in
  the wrong order deadlock under gloo and NCCL alike).

:class:`Wire` is what both the functions and the schedules of
``pipeline_parallel.py`` send through. Its transport is chosen from the
group's backend, never as a fallback after a failure: NCCL sends device
tensors as they are; gloo hands a CUDA tensor's device pointer to its TCP
transport (``writev ... Bad address`` on torch 2.11), so under gloo a CUDA
tensor is staged through pinned host memory (one copy out before the send,
one copy in after the receive), counted as ``p2p_host_staged`` in
``collective_counts()`` beside the sends and receives.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ....communication import p2p
from ....communication.collectives import _COUNTS
from ....communication.group import Group

# dtypes a stage boundary may carry, by their code in the meta message
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8)
_META_MAX = 16


class SendRecvMeta:
    """The shape and dtype of the activation a stage sends forward
    (reference class of the same name): sent over the wire once, before
    the first activation; the receiver allocates from it."""

    def __init__(self):
        self.send_shape_message: Optional[Tuple[int, ...]] = None
        self.send_dtype_message: Optional[torch.dtype] = None
        self.recv_shape_message: Optional[Tuple[int, ...]] = None
        self.recv_dtype_message: Optional[torch.dtype] = None
        self.has_send_meta = False
        self.has_recv_meta = False

    @staticmethod
    def encode(t: torch.Tensor) -> List[int]:
        if t.dtype not in _DTYPES:
            raise TypeError(f"a stage boundary carries {_DTYPES}, got "
                            f"{t.dtype}")
        if t.dim() + 2 > _META_MAX:
            raise ValueError(f"{t.dim()} dimensions exceed the meta message")
        return [t.dim(), _DTYPES.index(t.dtype), *t.shape]

    @staticmethod
    def decode(msg: Sequence[int]) -> Tuple[Tuple[int, ...], torch.dtype]:
        ndim, code = int(msg[0]), int(msg[1])
        return tuple(int(v) for v in msg[2:2 + ndim]), _DTYPES[code]

    def set_send_message(self, t: torch.Tensor) -> None:
        self.send_shape_message = tuple(t.shape)
        self.send_dtype_message = t.dtype
        self.has_send_meta = True

    def set_recv(self, shape, dtype) -> None:
        self.recv_shape_message, self.recv_dtype_message = shape, dtype
        self.has_recv_meta = True


class Wire:
    """Transfers over one ``group`` between global ranks, on ``device``.

    ``exchange(sends, recvs)`` issues every send (``(tensor, dst)``) and
    receive (``(tensor, src)``, filled in place) as one
    ``batch_isend_irecv`` and waits for them. Under gloo a CUDA tensor goes
    through a pinned host copy (``staged``)."""

    def __init__(self, group: Group, device: torch.device):
        self.group = group
        self.device = torch.device(device)
        self.staged = (group.backend == "gloo"
                       and self.device.type == "cuda")

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]] = (),
                 recvs: Sequence[Tuple[torch.Tensor, int]] = ()) -> None:
        if not sends and not recvs:
            return
        ops, back = [], []
        for t, dst in sends:
            t = t.detach().contiguous()
            if self.staged and t.is_cuda:
                host = self._host(t)
                host.copy_(t)
                _COUNTS["p2p_host_staged"] += 1
                t = host
            ops.append(p2p.P2POp(p2p.isend, t, dst, self.group))
        for t, src in recvs:
            buf = t
            if self.staged and t.is_cuda:
                buf = self._host(t)
                _COUNTS["p2p_host_staged"] += 1
                back.append((t, buf))
            ops.append(p2p.P2POp(p2p.irecv, buf, src, self.group))
        for task in p2p.batch_isend_irecv(ops):
            task.wait()
        for t, buf in back:
            t.copy_(buf)

    def meta_device(self) -> torch.device:
        """Where a meta message lives: the host under gloo, the card under
        NCCL (which moves device tensors only)."""
        return (torch.device("cpu") if self.group.backend == "gloo"
                else self.device)

    def meta_exchange(self, sends: Sequence[Tuple[torch.Tensor, int]] = (),
                      srcs: Sequence[int] = ()):
        """The shape and dtype of each tensor of ``sends`` to its ``dst``
        and, from each rank of ``srcs``, what it sends: one batch of
        fixed-size messages. Returns ``[(shape, dtype)]`` for ``srcs``."""
        dev = self.meta_device()
        out = [torch.full((_META_MAX,), -1, dtype=torch.int64, device=dev)
               for _ in srcs]
        msgs = []
        for t, dst in sends:
            msg = SendRecvMeta.encode(t)
            msgs.append((torch.tensor(msg + [-1] * (_META_MAX - len(msg)),
                                      dtype=torch.int64, device=dev), dst))
        self.exchange(msgs, list(zip(out, srcs)))
        return [SendRecvMeta.decode(m.tolist()) for m in out]


# ------------------------------------------------------- the module surface
_STATE = {}


def _endpoints(hcg):
    """(wire, meta, stage, stages, pp ranks) of ``hcg`` (default: the
    current topology). Both ends of every transfer come from the
    topology's pipe coordinate, so a ``send_forward`` at stage s and the
    ``recv_forward`` at s + 1 pair by construction."""
    if hcg is None:
        from ...base_topology import try_get_hybrid_communicate_group
        hcg = try_get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError(
            "pp_utils p2p needs a hybrid topology to derive both "
            "endpoints of the transfer: call fleet.init(...) first or "
            "pass hcg= explicitly")
    g = hcg.get_pipe_parallel_group()
    key = id(hcg)
    if key not in _STATE:
        from ....parallel import ParallelEnv
        dev = ParallelEnv().device or torch.device("cpu")
        _STATE.clear()
        _STATE[key] = (Wire(g, dev), SendRecvMeta())
    wire, meta = _STATE[key]
    return (wire, meta, hcg.get_stage_id(),
            hcg.get_pipe_parallel_world_size(), g.ranks)


def _skip(flag, stage, boundary) -> bool:
    return flag if flag is not None else stage == boundary


def send_forward(output_tensor, pp_last_stage: Optional[bool] = None,
                 hcg=None) -> None:
    """The activation to the next stage (none from the last stage); the
    first call sends the shape and dtype first."""
    if pp_last_stage:
        return
    wire, meta, s, n, ranks = _endpoints(hcg)
    if _skip(pp_last_stage, s, n - 1):
        return
    if not meta.has_send_meta:
        wire.meta_exchange([(output_tensor, ranks[s + 1])])
        meta.set_send_message(output_tensor)
    wire.exchange([(output_tensor, ranks[s + 1])])


def _recv_buffer(shape, dtype, wire) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=wire.device)


def recv_forward(pp_first_stage: Optional[bool] = None, hcg=None):
    """The previous stage's activation (None on the first stage)."""
    if pp_first_stage:
        return None
    wire, meta, s, n, ranks = _endpoints(hcg)
    if _skip(pp_first_stage, s, 0):
        return None
    if not meta.has_recv_meta:
        meta.set_recv(*wire.meta_exchange(srcs=[ranks[s - 1]])[0])
    t = _recv_buffer(meta.recv_shape_message, meta.recv_dtype_message, wire)
    wire.exchange(recvs=[(t, ranks[s - 1])])
    return t


def send_backward(input_tensor_grad, pp_first_stage: Optional[bool] = None,
                  hcg=None) -> None:
    """The gradient of this stage's input to the previous stage."""
    if pp_first_stage:
        return
    wire, _, s, n, ranks = _endpoints(hcg)
    if _skip(pp_first_stage, s, 0):
        return
    wire.exchange([(input_tensor_grad, ranks[s - 1])])


def recv_backward(pp_last_stage: Optional[bool] = None, hcg=None):
    """The gradient of this stage's output, shaped as what it sent
    forward (None on the last stage)."""
    if pp_last_stage:
        return None
    wire, meta, s, n, ranks = _endpoints(hcg)
    if _skip(pp_last_stage, s, n - 1):
        return None
    t = _recv_buffer(meta.send_shape_message, meta.send_dtype_message, wire)
    wire.exchange(recvs=[(t, ranks[s + 1])])
    return t


def send_forward_recv_backward(output_tensor,
                               pp_last_stage: Optional[bool] = None,
                               hcg=None):
    """The activation out and its gradient back, in one batch (None on the
    last stage)."""
    if pp_last_stage:
        return None
    wire, meta, s, n, ranks = _endpoints(hcg)
    if _skip(pp_last_stage, s, n - 1):
        return None
    if not meta.has_send_meta:
        wire.meta_exchange([(output_tensor, ranks[s + 1])])
        meta.set_send_message(output_tensor)
    g = _recv_buffer(meta.send_shape_message, meta.send_dtype_message, wire)
    wire.exchange([(output_tensor, ranks[s + 1])], [(g, ranks[s + 1])])
    return g


def send_backward_recv_forward(input_tensor_grad,
                               pp_first_stage: Optional[bool] = None,
                               hcg=None):
    """The input's gradient back and the next activation in, in one batch
    (None on the first stage)."""
    if pp_first_stage:
        return None
    wire, meta, s, n, ranks = _endpoints(hcg)
    if _skip(pp_first_stage, s, 0):
        return None
    if not meta.has_recv_meta:
        meta.set_recv(*wire.meta_exchange(srcs=[ranks[s - 1]])[0])
    x = _recv_buffer(meta.recv_shape_message, meta.recv_dtype_message, wire)
    wire.exchange([(input_tensor_grad, ranks[s - 1])], [(x, ranks[s - 1])])
    return x
