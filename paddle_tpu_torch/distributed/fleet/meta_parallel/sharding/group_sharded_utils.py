"""The ZeRO layout rule (a copy of
``paddle_tpu/distributed/fleet/meta_parallel/sharding/group_sharded_utils.py``
over plain tuples, without ``jax.sharding``).

A spec is a tuple with one entry a dimension, as a ``PartitionSpec``: None
(whole), an axis name, or a tuple of axis names (the dimension cut by their
product, the first major). ``sizes`` maps each mesh axis to its size. The
ZeRO stages differ only in which tensors take the extended spec:

  stage 1 ("os")     the optimizer slots and the f32 masters
  stage 2 ("os_g")   and the gradients
  stage 3 ("p_g_os") and the parameters themselves

:func:`extend_spec_with_sharding_on_mesh` and
:func:`resolve_sharding_axis_on_mesh` take a ``torch.distributed``
``DeviceMesh`` instead of ``sizes``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

#: level string (the reference's group_sharded_parallel API) -> stage
LEVEL_TO_STAGE = {"os": 1, "os_g": 2, "p_g_os": 3}


def _names(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_sizes(sizes: Mapping[str, int], entry) -> int:
    size = 1
    for n in _names(entry):
        size *= sizes[n]
    return size


def extend_spec_with_sharding(spec: Optional[Sequence],
                              shape: Sequence[int],
                              sizes: Mapping[str, int],
                              axis: str = "sharding") -> Tuple:
    """``spec`` with the ZeRO ``axis`` added: on the largest dimension the
    axis divides evenly, a free (None) one first; a dimension already cut
    (by ``mp``, say) is co-sharded as ``(..., axis)`` when no free one
    divides and its per-shard extent does. Unchanged when nothing
    divides, or when ``axis`` has one rank."""
    if sizes.get(axis, 1) <= 1:
        return tuple(spec) if spec is not None else ()
    size = sizes[axis]
    entries = list(spec) if spec is not None else []
    entries += [None] * (len(shape) - len(entries))

    best_dim, best_extent, best_free = -1, 0, False
    for d, (e, s) in enumerate(zip(entries, shape)):
        if e is not None:
            if axis in _names(e):
                return tuple(entries)  # already sharded over this axis
            per_shard = s // _axis_sizes(sizes, e)
            free = False
        else:
            per_shard = s
            free = True
        if per_shard % size != 0 or per_shard < size:
            continue
        # prefer free dims; among candidates take the largest extent
        if (free, per_shard) > (best_free, best_extent) and (
                free or not best_free):
            best_dim, best_extent, best_free = d, per_shard, free
    if best_dim < 0:
        return tuple(entries)
    e = entries[best_dim]
    entries[best_dim] = axis if e is None else _names(e) + (axis,)
    return tuple(entries)


def resolve_sharding_axis(sizes: Mapping[str, int]) -> Optional[str]:
    """The axis ZeRO shards over: ``sharding`` if it has more than one
    rank, else ``dp`` (ZeRO over the data-parallel ranks, as the reference
    fuses them), else None."""
    for a in ("sharding", "dp"):
        if sizes.get(a, 1) > 1:
            return a
    return None


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``)."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def extend_spec_with_sharding_on_mesh(spec, shape, mesh,
                                      axis: str = "sharding") -> Tuple:
    return extend_spec_with_sharding(spec, shape, mesh_sizes(mesh), axis)


def resolve_sharding_axis_on_mesh(mesh) -> Optional[str]:
    return resolve_sharding_axis(mesh_sizes(mesh))
