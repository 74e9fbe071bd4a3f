"""The all-gather and reduce-scatter the port runs over
``torch.distributed``, on flat views: gloo wants each rank's piece of the
output to have the input's shape, NCCL does not care. Each takes a process
group (None: the default one). :func:`gather_dim` and :func:`scatter_dim`
move a whole tensor and the ranks' slices of one of its dims: ZeRO-3's
params and gradients over 'data' (``launch.shardings``), and the weights
that tensor parallelism gathers over 'model' (``models.tensor_parallel``). NCCL runs them on the card, inside a CUDA
graph too; gloo on the CPU, and on CUDA tensors as well on the card's
torch (``chip_smoke.py`` phase 32 checks it, with the all-reduce), so two
ranks can share one card without a copy through host memory.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(out: torch.Tensor, x: torch.Tensor, group=None) -> torch.Tensor:
    """``out`` (contiguous, group size x ``x.numel()`` elements) <- every
    rank's ``x`` (contiguous), flat, in rank order; returns ``out``."""
    dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    return out


def reduce_scatter(out: torch.Tensor, x: torch.Tensor,
                   group=None) -> torch.Tensor:
    """``out`` (contiguous) <- the sum over the group of every rank's ``x``
    (contiguous, group size x ``out.numel()`` elements), rank r's r-th flat
    piece of it; returns ``out``."""
    dist.reduce_scatter_tensor(out.view(-1), x.view(-1), group=group)
    return out


def gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The whole tensor from the ``n`` ranks' slices ``t`` of its dim
    ``dim`` over ``group`` (an all-gather; a new tensor)."""
    flat = t.new_empty((n * t.numel(),))
    all_gather(flat, t.contiguous(), group)
    whole = list(t.shape)
    whole[dim] *= n
    return flat.view(n, *t.shape).movedim(0, dim).reshape(whole)


def scatter_dim(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's slice of dim ``dim`` of the sum over ``group`` of every
    rank's whole ``g`` (a reduce-scatter; a new contiguous tensor)."""
    shape = list(g.shape)
    split = shape[:dim] + [n, shape[dim] // n] + shape[dim + 1:]
    ranks_first = g.reshape(split).movedim(dim, 0).contiguous()
    local = shape[:dim] + [shape[dim] // n] + shape[dim + 1:]
    out = g.new_empty(local)
    reduce_scatter(out, ranks_first, group)
    return out
