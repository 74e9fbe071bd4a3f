"""How a tensor lies over a device mesh: the mesh's axes and sizes, a
spec's DTensor placements, and a rank's slice of a whole tensor.

The launch layer builds meshes (:mod:`repro_torch.launch.mesh`) and the
sharding rules (:mod:`repro_torch.launch.shardings`); the models
(:mod:`repro_torch.models.partitioning`) and the checkpoints read layouts
through this module, which depends on neither. A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` or, where only axis names and
sizes are read, a plain ``{axis: size}`` mapping, so the rules can be
checked for meshes larger than the processes that run them.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's axis order, of a ``DeviceMesh`` or of
    a mapping (the reference's ``mesh.shape``)."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no axis names")
    return {a: int(n) for a, n in zip(names, mesh.shape)}


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def named(mesh, *spec) -> tuple:
    """The DTensor placements of ``spec`` (one entry per tensor dim: None, an
    axis name or a tuple of axis names) on ``mesh``: per mesh axis,
    ``Shard(dim)`` where the spec puts it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    where: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for axis in (() if entry is None else
                     (entry,) if isinstance(entry, str) else entry):
            if axis not in names:
                raise ValueError(f"spec {spec}: no axis {axis!r} in {names}")
            if axis in where:
                raise ValueError(f"spec {spec}: axis {axis!r} used twice")
            where[axis] = dim
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)


def shard_dim(placements, mesh, axis: str) -> Optional[int]:
    """The tensor dim ``placements`` shard over ``axis``, or None."""
    p = placements[axis_names(mesh).index(axis)]
    return p.dim if p.is_shard() else None


def coordinate(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(index, count) of this rank over ``axes``, flattened in the mesh's
    axis order (the first axis slowest), as a spec entry of those axes lays
    a dim out."""
    shape = mesh_shape(mesh)
    coord = dict(zip(shape, mesh.get_coordinate()))
    index, count = 0, 1
    for a in shape:
        if a in axes:
            index, count = index * shape[a] + coord[a], count * shape[a]
    return index, count


def sharded_axes(placements, mesh) -> List[Tuple[str, int, int]]:
    """(axis, tensor dim, axis size) of every mesh axis that shards a leaf,
    in the mesh's axis order."""
    shape = mesh_shape(mesh)
    return [(a, p.dim, shape[a]) for a, p in zip(shape, placements)
            if p.is_shard()]


def local_shard(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``placements``
    (a contiguous copy; ``t`` itself where nothing shards it). The first
    mesh axis splits a dim first, as a spec entry of several axes does."""
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    out = t
    for axis, dim, n in sharded_axes(placements, mesh):
        out = torch.tensor_split(out, n, dim)[coord[axis]]
    return t if out is t else out.contiguous()


def whole_shape(local_shape, placements, mesh) -> tuple:
    """The shape of the whole tensor whose slice has ``local_shape``."""
    shape = list(local_shape)
    for _, dim, n in sharded_axes(placements, mesh):
        shape[dim] *= n
    return tuple(shape)
