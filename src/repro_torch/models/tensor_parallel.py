"""Megatron-style tensor parallelism over the mesh's 'model' axis.

The reference has no counterpart: there GSPMD splits what the sharding
rules (``launch/shardings.py``) put on 'model' and inserts the collectives
itself. The port's layers hold each rank's slices of those leaves (the
rules' placements, ``layout.local_shard``) and move activations between the
ranks of the 'model' axis through the three autograd functions here:

* :func:`copy_to_model`: the identity; its backward all-reduces the
  gradient. It stands where a tensor replicated over 'model' (a block's
  input, a weight left whole) enters work that each rank does on its own
  slice, so each rank's partial gradient becomes the whole one.
* :func:`reduce_from_model`: an all-reduce (sum); its backward is the
  identity. It ends that work: the ranks' partial outputs -> the output,
  replicated over 'model'.
* :func:`gather_from_model`: an all-gather of the ranks' slices of a dim;
  its backward reduce-scatters the gradient (each rank's is partial there:
  the work after the gather is split again before its reduce), or, with
  ``whole_grad`` (the work after it runs whole on every rank, as DeepSeek's
  MTP block after its ``proj``), takes this rank's slice of it.

Activations between blocks are replicated over 'model'. Each function reads
the mesh that :mod:`.partitioning` registers and goes through
:mod:`repro_torch.collectives` (or ``torch.distributed`` for the sums); with
no mesh, or a 'model' axis of 1, it returns its input untouched and runs no
collective. Like :mod:`repro_torch.layout`, this module imports nothing of
``launch/``.

``counts`` counts this rank's collectives over 'model', forward and backward
alike: ``all_reduce`` (the sums of :func:`reduce_from_model`,
:func:`max_over_model` and :func:`copy_to_model`'s backward),
``all_gather`` (:func:`gather_from_model`) and ``reduce_scatter`` (its
backward), each beside ``<kind>_bytes``, the bytes of the whole tensor (the
sum's, the gathered one's, the one scattered). The caller resets it
(``counts.clear()``).
"""
from __future__ import annotations

import collections
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.layout import coordinate, mesh_shape
from . import partitioning as part

AXIS = "model"

counts = collections.Counter()


def _count(kind: str, t: torch.Tensor) -> None:
    counts[kind] += 1
    counts[f"{kind}_bytes"] += t.numel() * t.element_size()


def model_size() -> int:
    """The size of the registered mesh's 'model' axis (1 with no mesh)."""
    mesh = part.current_mesh()
    return 1 if mesh is None else mesh_shape(mesh).get(AXIS, 1)


def model_index() -> int:
    """This rank's index along 'model' (0 with no mesh)."""
    if model_size() == 1:
        return 0
    return coordinate(part.current_mesh(), (AXIS,))[0]


def local_range(n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's part of ``n`` items split over 'model', as
    ``layout.local_shard`` splits them (the rules split only a dim that
    'model' divides)."""
    step = n // model_size()
    lo = model_index() * step
    return lo, lo + step


def _group():
    return part.current_mesh().get_group(AXIS)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _count("all_reduce", g)
        dist.all_reduce(g, group=_group())
        return g


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        _count("all_reduce", out)
        dist.all_reduce(out, group=_group())
        return out

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, whole_grad: bool):
        ctx.dim, ctx.whole_grad = dim, whole_grad
        out = collectives.gather_dim(x, dim, _group(), model_size())
        _count("all_gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.whole_grad:
            lo, hi = local_range(g.shape[ctx.dim])
            return g.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None
        _count("reduce_scatter", g)
        return (collectives.scatter_dim(g, ctx.dim, _group(), model_size()),
                None, None)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over 'model') as the input of per-rank work: the
    gradient that comes back is summed over 'model'."""
    return x if model_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over 'model' of every rank's ``x`` (a new tensor)."""
    return x if model_size() == 1 else _ReduceFromModel.apply(x)


def gather_from_model(x: torch.Tensor, dim: int,
                      whole_grad: bool = False) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's slice of dim ``dim``
    (equal slices, in rank order). Its gradient is summed over 'model'
    (each rank's is its part), or with ``whole_grad`` taken as it is (each
    rank's is the whole one)."""
    return x if model_size() == 1 else _GatherFromModel.apply(
        x, dim % x.dim(), whole_grad)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over 'model' of every rank's ``x``, with no
    gradient (``x`` detached with no 'model' axis)."""
    if model_size() == 1:
        return x.detach()
    out = x.detach().clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group())
    return out
