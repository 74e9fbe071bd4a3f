"""The all-gather and reduce-scatter the port runs over
``torch.distributed``, on flat views: gloo wants each rank's piece of the
output to have the input's shape, NCCL does not care. Each takes a process
group (None: the default one). NCCL runs them on the card, inside a CUDA
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
