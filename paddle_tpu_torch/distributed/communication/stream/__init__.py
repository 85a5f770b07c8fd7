"""``paddle.distributed.communication.stream`` (counterpart of
``paddle_tpu/distributed/communication/stream/__init__.py``): the
collectives with ``use_calc_stream``. PyTorch issues NCCL work on its own
stream and orders it after the current stream's, so the argument is taken
and changes nothing, as in the reference."""

from __future__ import annotations

from .. import collectives as _c
from .. import p2p as _p
from ..group import ReduceOp


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True, **kw):
    return _c.all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def all_gather(tensor_or_list, tensor, group=None, sync_op=True, **kw):
    return _c.all_gather(tensor_or_list, tensor, group=group, sync_op=sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True, **kw):
    return _c.reduce(tensor, dst=dst, op=op, group=group, sync_op=sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True, **kw):
    return _c.broadcast(tensor, src=src, group=group, sync_op=sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True, **kw):
    return _c.scatter(tensor, tensor_list=tensor_list, src=src, group=group,
                      sync_op=sync_op)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True, **kw):
    return _c.reduce_scatter(tensor, tensor_list, op=op, group=group,
                             sync_op=sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True, **kw):
    return _c.alltoall(out_tensor_list, in_tensor_list, group=group,
                       sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True, **kw):
    return _c.alltoall_single(out_tensor, in_tensor, in_split_sizes,
                              out_split_sizes, group=group, sync_op=sync_op)


def send(tensor, dst=0, group=None, sync_op=True, **kw):
    return _p.send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True, **kw):
    return _p.recv(tensor, src=src, group=group, sync_op=sync_op)
