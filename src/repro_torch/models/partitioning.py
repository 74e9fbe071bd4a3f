"""Activation-sharding constraints for model internals.

Counterpart of the reference's ``models/partitioning.py``. The launch layer
registers the active mesh and the batch axes here; model code calls
:func:`constrain` where the reference steers GSPMD (MoE dispatch and
combine). Under the port's data parallelism every activation is a plain
tensor holding this rank's rows, so ``constrain`` returns it as it is; a
``DTensor`` is redistributed to the spec's placements. With no mesh
registered ``constrain`` returns its argument. Like the reference's, it
never raises on a spec it cannot apply.

:func:`batch_mean` is what GSPMD does for the reference when a model takes a
mean over the batch: the mean of a per-rank mean over the ranks that hold
the batch's rows (the registered batch axes).

A decode step whose KV caches hold a slice of their length on each rank
(``launch.steps.make_decode_step`` under a mesh) registers
``cache_axes``, the axes that split it; attention's decode then attends
over its slice and the ranks combine (``layers.attn_decode``).

A caller that gives each rank a contiguous shard of the tokens registers
``seq_axis="model"`` (the reference's ``input_pspec`` puts tokens on
'model'): the train step does, for a ``seq_shard`` config whose tokens it
splits (``launch.steps.make_train_step``), and so may a caller of the
model's loss. It is the one gate of that split. Under it causal attention
of a ``seq_shard`` config runs the ring (``layers.attn_apply``), and what
the ring does not cover raises NotImplementedError rather than compute
over the rank's shard alone: other attention (``attn_apply``), and any
other model (``transformer.forward``, ``init_cache``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.layout import coordinate, mesh_shape, named

_STATE = {"mesh": None, "batch_axes": ("data",), "seq_axis": None,
          "cache_axes": ()}


def set_mesh(mesh, batch_axes: Tuple[str, ...] = ("data",),
             seq_axis: Optional[str] = None, cache_axes: Tuple[str, ...] = ()):
    if seq_axis not in (None, "model"):
        raise ValueError(f"seq_axis {seq_axis!r}: the tokens split over "
                         "'model' only")
    _STATE["mesh"] = mesh
    _STATE["batch_axes"] = tuple(batch_axes)
    _STATE["seq_axis"] = seq_axis
    _STATE["cache_axes"] = tuple(cache_axes)


@contextlib.contextmanager
def use_mesh(mesh, batch_axes: Tuple[str, ...] = ("data",),
             seq_axis: Optional[str] = None, cache_axes: Tuple[str, ...] = ()):
    prev = (_STATE["mesh"], _STATE["batch_axes"], _STATE["seq_axis"],
            _STATE["cache_axes"])
    set_mesh(mesh, batch_axes, seq_axis, cache_axes)
    try:
        yield
    finally:
        set_mesh(*prev)


def current_mesh():
    """The registered mesh, or None."""
    return _STATE["mesh"]


def batch_axes() -> Tuple[str, ...]:
    return _STATE["batch_axes"]


def cache_axes() -> Tuple[str, ...]:
    """The axes of size above 1 that the registered decode step's KV
    caches split their length over, in mesh order (the rules' layouts
    (b) and (c): ``launch.shardings.cache_pspec``); () with none."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return ()
    shape = mesh_shape(mesh)
    return tuple(a for a in _STATE["cache_axes"] if shape.get(a, 1) > 1)


def cache_index() -> Tuple[int, int]:
    """(index, count) of this rank over :func:`cache_axes`: its slice of a
    cache of C slots holds slots [index * C / count, (index + 1) * C /
    count)."""
    axes = cache_axes()
    return coordinate(_STATE["mesh"], axes) if axes else (0, 1)


def seq_axis() -> Optional[str]:
    """The axis the tokens are split over, where the caller registered one
    whose size is above 1, else None."""
    axis, mesh = _STATE["seq_axis"], _STATE["mesh"]
    if axis is None or mesh is None or mesh_shape(mesh).get(axis, 1) == 1:
        return None
    return axis


def seq_index() -> int:
    """This rank's index along :func:`seq_axis` (0 with none): its shard of
    L tokens starts at position ``seq_index() * L``."""
    axis = seq_axis()
    return 0 if axis is None else coordinate(_STATE["mesh"], (axis,))[0]


def resolve(*spec) -> tuple:
    """``spec`` with 'BATCH' expanded to the registered batch axes."""
    return tuple(_STATE["batch_axes"] if s == "BATCH" else s for s in spec)


def constrain(x, *spec):
    """``x`` laid out as ``spec`` on the registered mesh: a ``DTensor`` is
    redistributed to the spec's placements; anything else, or any ``x`` with
    no mesh registered, is returned as it is.

    Spec entries: None, a mesh axis name, 'BATCH' (the registered batch
    axes), or a tuple of axis names."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    try:
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, named(mesh, *resolve(*spec)))
    except Exception:
        return x


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the registered batch axes (a new
    tensor; ``x`` is not written), or ``x`` with no mesh registered. Every
    rank of those axes must call it. ``x`` takes no gradient through it."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    shape = mesh_shape(mesh)
    out = x.detach().clone()
    n = 1
    for axis in _STATE["batch_axes"]:
        if axis in shape:
            dist.all_reduce(out, group=mesh.get_group(axis))
            n *= shape[axis]
    return out / n
