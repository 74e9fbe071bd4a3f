"""The all-gather and reduce-scatter the port runs over
``torch.distributed``, on flat views: gloo wants each rank's piece of the
output to have the input's shape, NCCL does not care; and the ring's
point-to-point moves. Each takes a process group (None: the default
one). :func:`gather_dim` and :func:`scatter_dim` move a whole tensor and
the ranks' slices of one of its dims: ZeRO-3's params and gradients over
'data' (``launch.shardings``), and the weights that tensor parallelism
gathers over 'model' (``models.tensor_parallel``). NCCL runs them on the
card, inside a CUDA graph too; gloo on the CPU, and on CUDA tensors as
well on the card's torch (``chip_smoke.py`` phase 32 checks it, with the
all-reduce), so two ranks can share one card without a copy through host
memory.

:func:`ring_pull` and :func:`ring_push` are the moves of ring
context-parallel attention (``kernels.ops.cp_flash_attention``): each rank
of a group pulls the tensors of its ``r`` predecessors, and sends their
gradients back. They go through :func:`p2p`, one ``batch_isend_irecv`` a
call with every send and receive of the call in it, so every rank of the
group takes part in each batch (NCCL wants that of a group's first) and no
two messages of a batch share a pair of ranks and a direction. NCCL moves
CUDA tensors as they are. gloo's send and receive take a host pointer, so
under gloo a CUDA tensor is staged: copied to the host before it is sent,
received into a host buffer and copied back; ``p2p.staged`` counts those
copies.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

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


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a send or receive of ``t`` over ``group`` goes through a host
    buffer: a tensor off the host under gloo."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _global(group, peer: int) -> int:
    return peer if group is None else dist.get_global_rank(group, peer)


def p2p(sends: Sequence[Tuple[torch.Tensor, int]],
        recvs: Sequence[Tuple[torch.Tensor, int]], group=None) -> None:
    """Post every send ``(tensor, group rank)`` and receive ``(buffer, group
    rank)`` in one ``batch_isend_irecv`` and wait for all of them; each
    tensor contiguous. The buffers are written in place. With nothing to
    move it calls nothing."""
    if not sends and not recvs:
        return
    ops, back = [], []
    for t, peer in sends:
        if _staged(t, group):
            t = t.cpu()
            p2p.staged += 1
        ops.append(dist.P2POp(dist.isend, t, _global(group, peer), group))
    for buf, peer in recvs:
        host = buf
        if _staged(buf, group):
            host = torch.empty(buf.shape, dtype=buf.dtype)
            back.append((buf, host))
        ops.append(dist.P2POp(dist.irecv, host, _global(group, peer), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for buf, host in back:
        buf.copy_(host)
        p2p.staged += 1


p2p.staged = 0


def ring_pull(x: torch.Tensor, r: int, group=None) -> List[torch.Tensor]:
    """The ``x`` (contiguous; of one shape on every rank) of the group
    ranks ``idx - r' .. idx - 1``, in rank order, where ``idx`` is this
    rank's and ``r' = min(idx, r)``: the reference's ``ppermute`` pairs
    ``(i, i + step)`` for ``step = 1 .. r``, without the zeros that the
    first ranks receive there. This rank's ``x`` goes to ``idx + 1 ..
    min(idx + r, n - 1)``. New tensors; an empty list where ``r'`` is 0."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    got = [torch.empty_like(x) for _ in range(min(idx, r))]
    p2p([(x, dst) for dst in range(idx + 1, min(idx + r, n - 1) + 1)],
        list(zip(got, range(idx - len(got), idx))), group)
    return got


def ring_push(parts: Sequence[torch.Tensor], r: int, group=None, *,
              like: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`ring_pull`: ``parts`` (contiguous, one for
    each tensor that ``ring_pull`` gave this rank, in its order) go back to
    their ranks; returns the sum of the parts that this rank's successors
    ``idx + 1 .. min(idx + r, n - 1)`` send it, a new float32 tensor of
    ``like``'s shape on its device (zeros where none does), so that a bf16
    gradient is rounded once, after its last term is added."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if len(parts) != min(idx, r):
        raise ValueError(f"ring_push: {len(parts)} parts at rank {idx} of {n} "
                         f"with r {r}; ring_pull gave {min(idx, r)}")
    got = [torch.empty_like(like) for _ in range(idx + 1, min(idx + r, n - 1) + 1)]
    p2p(list(zip(parts, range(idx - len(parts), idx))),
        list(zip(got, range(idx + 1, idx + 1 + len(got)))), group)
    out = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
    for g in got:
        out += g
    return out
