"""Fused AdamW with the global-norm clip: the CUDA kernels ``csrc/adamw.cu``
and their plain versions.

Counterpart of the reference's ``clip_by_global_norm`` followed by
``adamw().update`` (:mod:`repro.optim.optimizers`), which XLA fuses into one
loop per leaf once the train step is jitted; the reference has no Pallas
kernel for them. A CUDA leaf goes to the kernels, a CPU leaf to the plain
versions in :mod:`.ref`:

* :func:`global_norm_scale` -> (norm, scale) of the clip: one ``sumsq``
  launch per leaf (partial sums of squares into a workspace) and one
  ``clip_finalize`` launch, which sums them in a fixed order and writes
  norm and scale to the device;
* :func:`adamw_update` updates one leaf in place (p in its storage dtype,
  m and v float32), reading lr, the bias corrections and the clip's scale
  from 0-d device tensors, so a CUDA graph replays them as they change.

The kernels take contiguous tensors and refuse others. Each is an operator
(``repro_torch::sumsq``, ``clip_finalize``, ``adamw_update``; see
``_checks``), counted as 2 flops an element (``sumsq``), 1 a partial sum
and 17 an element of the update.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.flop_counter import register_flop_formula

from repro_torch import collectives
from . import _build
from ._checks import DTYPE_CODES, H100_SMS, plain, require_cuda
from .ref import adamw_update_ref as adamw_update_plain
from .ref import clip_finalize_ref as clip_finalize_plain
from .ref import global_norm_scale_ref as global_norm_scale_plain
from .ref import norm_scale_ref as norm_scale_plain
from .ref import sumsq_ref as sumsq_plain

# csrc/adamw.cu: threads a block, 16-byte vectors in flight a thread in
# sumsq, blocks per SM of either grid at most
THREADS = 256
SUMSQ_UNROLL = 4
BLOCKS_PER_SM = 8


def _vec(dtype: torch.dtype) -> int:
    return 16 // dtype.itemsize


def sumsq_blocks(numel: int, dtype: torch.dtype, n_sm: int) -> int:
    """Blocks (so partial sums) of ``sumsq`` over a leaf: enough for every
    thread to have SUMSQ_UNROLL vectors, at most BLOCKS_PER_SM a SM. Fixed
    by the leaf's size and the card, so is the order of every sum."""
    per_block = THREADS * SUMSQ_UNROLL * _vec(dtype)
    return max(1, min(-(-numel // per_block), BLOCKS_PER_SM * n_sm))


def update_blocks(numel: int, dtype: torch.dtype, n_sm: int) -> int:
    """Blocks of ``adamw_update`` over a leaf: a vector a thread, at most
    BLOCKS_PER_SM a SM (the rest in a grid-stride loop)."""
    return max(1, min(-(-numel // (THREADS * _vec(dtype))), BLOCKS_PER_SM * n_sm))


def _check_leaf(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not in {list(DTYPE_CODES)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors, got "
                         f"strides {t.stride()} for shape {tuple(t.shape)}")


def _check_scalar(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
            and t.numel() == 1 and t.device == like.device):
        raise ValueError(f"{name}: lr, c1, c2 and scale must be float32 "
                         f"tensors of one element on {like.device}")


def sumsq_cuda(g: torch.Tensor, partial: torch.Tensor) -> None:
    """Launch ``sumsq`` over leaf ``g`` (contiguous, bf16 or float32): one
    float32 sum of squares per block into ``partial``, a contiguous float32
    tensor of ``sumsq_blocks(g.numel(), ...)`` elements."""
    require_cuda("sumsq", g, partial)
    _check_leaf("sumsq", g)
    blocks = sumsq_blocks(g.numel(), g.dtype, _build.sm_count(g.device.index))
    if (partial.dtype != torch.float32 or not partial.is_contiguous()
            or partial.numel() != blocks):
        raise ValueError(f"sumsq: partial must be {blocks} contiguous float32, "
                         f"got {partial.dtype} {tuple(partial.shape)}")
    _build.check(_build.load().adamw_sumsq(
        g.data_ptr(), g.numel(), partial.data_ptr(), blocks, DTYPE_CODES[g.dtype],
        _build.stream_handle(g)), "adamw_sumsq")
    sumsq_cuda.launches += 1


sumsq_cuda.launches = 0


def clip_finalize_cuda(partial: torch.Tensor, max_norm: float,
                       out: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``clip_finalize``: the sums of squares in ``partial``
    (contiguous float32) -> (norm, scale), 0-d float32 on the device, the
    two elements of ``out`` (a float32 tensor of 2, made if None)."""
    require_cuda("clip_finalize", partial)
    if partial.dtype != torch.float32 or not partial.is_contiguous() \
            or partial.numel() == 0:
        raise ValueError("clip_finalize: partial must be non-empty contiguous float32")
    if out is None:
        out = torch.empty(2, dtype=torch.float32, device=partial.device)
    _build.check(_build.load().adamw_clip_finalize(
        partial.data_ptr(), partial.numel(), float(max_norm), out.data_ptr(),
        _build.stream_handle(partial)), "adamw_clip_finalize")
    clip_finalize_cuda.launches += 1
    return out[0], out[1]


clip_finalize_cuda.launches = 0


@torch.library.custom_op("repro_torch::sumsq", mutates_args=("partial",),
                         device_types="cuda")
def sumsq_op(g: torch.Tensor, partial: torch.Tensor) -> None:
    sumsq_cuda(g, partial)


@sumsq_op.register_kernel("cpu")
def _(g, partial):
    partial.zero_()
    partial[0] = sumsq_plain(g)


@sumsq_op.register_fake
def _(g, partial):
    return None


@torch.library.custom_op("repro_torch::clip_finalize", mutates_args=(),
                         device_types="cuda")
def clip_finalize_op(partial: torch.Tensor, max_norm: float) -> torch.Tensor:
    """(norm, scale) as one float32 tensor of 2."""
    out = torch.empty(2, dtype=torch.float32, device=partial.device)
    clip_finalize_cuda(partial, max_norm, out)
    return out


@clip_finalize_op.register_kernel("cpu")
def _(partial, max_norm):
    return torch.stack(clip_finalize_plain(partial, max_norm))


@clip_finalize_op.register_fake
def _(partial, max_norm):
    return partial.new_empty((2,))


@register_flop_formula(torch.ops.repro_torch.sumsq, get_raw=True)
def _(g, *args, out_val=None, **kwargs) -> int:
    return 2 * g.numel()


@register_flop_formula(torch.ops.repro_torch.clip_finalize, get_raw=True)
def _(partial, *args, out_val=None, **kwargs) -> int:
    return partial.numel()


def global_norm_scale_cuda(grads: List[torch.Tensor],
                           max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clip's (norm, scale) over ``grads`` through the operators (on
    the card the kernels): ``sumsq`` per leaf into one workspace, each leaf
    at a fixed offset, then ``clip_finalize`` over all of it."""
    partial, _ = _sumsq_partials(grads)
    return tuple(clip_finalize_op(partial, max_norm).unbind())


def _sumsq_partials(grads: List[torch.Tensor]) -> Tuple[torch.Tensor, List[int]]:
    """(workspace, blocks of each leaf): ``sumsq`` per leaf into one
    workspace, each leaf at a fixed offset; the card's launch plan (an
    H100's for a tensor off the card)."""
    dev = grads[0].device
    n_sm = _build.sm_count(dev.index) if dev.type == "cuda" else H100_SMS
    blocks = [sumsq_blocks(g.numel(), g.dtype, n_sm) for g in grads]
    partial = torch.empty(sum(blocks), dtype=torch.float32, device=dev)
    for g, piece in zip(grads, torch.split(partial, blocks)):
        sumsq_op(g, piece)
    return partial, blocks


def global_norm_scale(grads: List[torch.Tensor], max_norm: float,
                      splits: Sequence[Tuple[Sequence[bool], Any]] = ()
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(norm, scale) of global-norm clipping to ``max_norm``: the kernels
    for CUDA leaves, the plain version for CPU ones.

    ``splits``: (a flag per leaf, a process group) pairs. A flag marks a
    leaf that holds this rank's slice of a gradient split over the group
    (ZeRO-3 over 'data', tensor parallelism over 'model'). Each leaf's
    partial sums of squares are gathered over each of its groups in turn,
    in rank order (a leaf split over two is gathered over both), and every
    leaf's partials, in leaf order, go to one ``clip_finalize``, so every
    rank gets the whole gradient's norm, and two calls the same bits. A
    leaf no flag marks is counted once. With one rank in each group these
    are the unsharded call's partials, in its order."""
    splits = [(flags, group) for flags, group in splits if any(flags)]
    on_plain = plain("global_norm_scale", grads[0])
    if not splits:
        if on_plain:
            return global_norm_scale_plain(grads, max_norm)
        return global_norm_scale_cuda(grads, max_norm)
    if on_plain:
        partial, blocks = torch.stack([sumsq_plain(g) for g in grads]), \
            [1] * len(grads)
    else:
        partial, blocks = _sumsq_partials(grads)
    for flags, group in splits:
        partial, blocks = _every_rank(partial, blocks, flags, group)
    if on_plain:
        return norm_scale_plain(list(partial.unbind()), max_norm)
    return tuple(clip_finalize_op(partial, max_norm).unbind())


def _every_rank(partial: torch.Tensor, blocks: List[int],
                sharded: Sequence[bool], group) -> Tuple[torch.Tensor, List[int]]:
    """This rank's partial sums (``blocks`` a leaf, in leaf order) -> the
    partials of the whole gradient in leaf order and their blocks a leaf:
    a replicated leaf's own, a sharded leaf's from every rank of ``group``
    in rank order."""
    pieces = torch.split(partial, blocks)
    mine = torch.cat([p for p, s in zip(pieces, sharded) if s])
    n = dist.get_world_size(group)
    every = collectives.all_gather(mine.new_empty(n * mine.numel()), mine,
                                   group).view(n, -1)
    out, at = [], 0
    for p, s in zip(pieces, sharded):
        if s:
            out.append(every[:, at:at + p.numel()].reshape(-1))
            at += p.numel()
        else:
            out.append(p)
    return torch.cat(out), [p.numel() for p in out]


def adamw_update_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
                      c2: torch.Tensor, scale: Optional[torch.Tensor] = None,
                      b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                      weight_decay: float = 0.1) -> None:
    """Launch ``adamw_update`` on one leaf, in place: p (bf16 or float32)
    and g in p's dtype, m and v float32, all contiguous and of one shape;
    lr, c1, c2 and ``scale`` (or None: no clip) float32 one-element device
    tensors. Weight decay applies where p.ndim >= 2, as the reference's."""
    require_cuda("adamw_update", p, g, m, v)
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _check_leaf(f"adamw_update: {name}", t)
    if g.dtype != p.dtype or m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"adamw_update: g must be p's dtype {p.dtype} and m, v "
                        f"float32, got {g.dtype}, {m.dtype}, {v.dtype}")
    if not (g.shape == m.shape == v.shape == p.shape):
        raise ValueError("adamw_update: p, g, m and v must have one shape")
    for t in (lr, c1, c2) + (() if scale is None else (scale,)):
        _check_scalar("adamw_update", t, p)
    blocks = update_blocks(p.numel(), p.dtype, _build.sm_count(p.device.index))
    _build.check(_build.load().adamw_update(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
        lr.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        None if scale is None else scale.data_ptr(),
        b1, 1 - b1, b2, 1 - b2, eps, weight_decay, int(p.dim() >= 2), blocks,
        DTYPE_CODES[p.dtype], _build.stream_handle(p)), "adamw_update")
    adamw_update_cuda.launches += 1


adamw_update_cuda.launches = 0


@torch.library.custom_op("repro_torch::adamw_update", mutates_args=("p", "m", "v"),
                         device_types="cuda")
def adamw_update_op(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
                    c2: torch.Tensor, scale: Optional[torch.Tensor], b1: float,
                    b2: float, eps: float, weight_decay: float) -> None:
    adamw_update_cuda(p, g, m, v, lr, c1, c2, scale, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay)


@adamw_update_op.register_kernel("cpu")
def _(p, g, m, v, lr, c1, c2, scale, b1, b2, eps, weight_decay):
    adamw_update_plain(p, g, m, v, lr, c1, c2, scale, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay)


@adamw_update_op.register_fake
def _(p, g, m, v, lr, c1, c2, scale, b1, b2, eps, weight_decay):
    return None


@register_flop_formula(torch.ops.repro_torch.adamw_update, get_raw=True)
def _(p, *args, out_val=None, **kwargs) -> int:
    return 17 * p.numel()


def adamw_update(p, g, m, v, lr, c1, c2, scale=None, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> None:
    """One leaf's AdamW update in place: the plain version for real CPU
    tensors, the operator otherwise (arguments as
    :func:`adamw_update_cuda`)."""
    if plain("adamw_update", p):
        return adamw_update_plain(p, g, m, v, lr, c1, c2, scale, b1=b1, b2=b2,
                                  eps=eps, weight_decay=weight_decay)
    adamw_update_op(p, g, m, v, lr, c1, c2, scale, b1, b2, eps, weight_decay)
