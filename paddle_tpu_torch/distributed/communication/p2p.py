"""Point-to-point transfers (counterpart of
``paddle_tpu/distributed/communication/p2p.py``): ``send`` / ``recv`` /
``isend`` / ``irecv`` and ``batch_isend_irecv`` between real ranks.

The reference's single controller holds every rank, so its ``send``
deposits a value in a mailbox keyed by the sender and receiver it is told
(``src=`` / ``dst=``) and ``recv`` collects it. Here the sender and the
receiver are two processes: ``send`` goes to the global rank ``dst``,
``recv`` fills its tensor from the global rank ``src``, and the caller's own
rank is the other end.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .collectives import _COUNTS, Task
from .group import Group, _get_global_group


def _peer_group(group: Optional[Group], peer: int, what: str):
    group = _get_global_group(group)
    if group.get_group_rank(peer) < 0:
        raise ValueError(f"{what} rank {peer} not in group {group.ranks}")
    return group


def send(tensor: torch.Tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True) -> Task:
    group = _peer_group(group, dst, "dst")
    _COUNTS["send"] += 1
    if sync_op:
        dist.send(tensor, dst, group.process_group)
        return Task()
    return Task(dist.isend(tensor, dst, group.process_group))


def recv(tensor: torch.Tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True) -> Task:
    group = _peer_group(group, src, "src")
    _COUNTS["recv"] += 1
    if sync_op:
        dist.recv(tensor, src, group.process_group)
        return Task()
    return Task(dist.irecv(tensor, src, group.process_group))


def isend(tensor: torch.Tensor, dst: int = 0,
          group: Optional[Group] = None) -> Task:
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor: torch.Tensor, src: int = 0,
          group: Optional[Group] = None) -> Task:
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One transfer of a batch (reference: ``paddle.distributed.P2POp``):
    ``op`` is ``isend`` / ``irecv`` (or ``send`` / ``recv``), ``peer`` the
    other end's global rank."""

    def __init__(self, op, tensor: torch.Tensor, peer: int,
                 group: Optional[Group] = None):
        if op not in (send, recv, isend, irecv):
            raise ValueError("P2POp op must be paddle.distributed."
                             "{send,recv,isend,irecv}")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = _peer_group(group, peer, "peer")


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> List[Task]:
    """Issue the batch's transfers together; returns one task each."""
    ops = []
    for o in p2p_op_list:
        sending = o.op in (send, isend)
        _COUNTS["send" if sending else "recv"] += 1
        ops.append(dist.P2POp(dist.isend if sending else dist.irecv,
                              o.tensor, o.peer, o.group.process_group))
    return [Task(w) for w in dist.batch_isend_irecv(ops)]
