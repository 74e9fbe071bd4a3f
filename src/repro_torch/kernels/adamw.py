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

The kernels take contiguous tensors and refuse others.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda
from .ref import adamw_update_ref as adamw_update_plain
from .ref import clip_finalize_ref as clip_finalize_plain
from .ref import global_norm_scale_ref as global_norm_scale_plain
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


def clip_finalize_cuda(partial: torch.Tensor,
                       max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``clip_finalize``: the sums of squares in ``partial``
    (contiguous float32) -> (norm, scale), 0-d float32 on the device."""
    require_cuda("clip_finalize", partial)
    if partial.dtype != torch.float32 or not partial.is_contiguous() \
            or partial.numel() == 0:
        raise ValueError("clip_finalize: partial must be non-empty contiguous float32")
    out = torch.empty(2, dtype=torch.float32, device=partial.device)
    _build.check(_build.load().adamw_clip_finalize(
        partial.data_ptr(), partial.numel(), float(max_norm), out.data_ptr(),
        _build.stream_handle(partial)), "adamw_clip_finalize")
    clip_finalize_cuda.launches += 1
    return out[0], out[1]


clip_finalize_cuda.launches = 0


def global_norm_scale_cuda(grads: List[torch.Tensor],
                           max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clip's (norm, scale) over ``grads`` on the card: ``sumsq`` per
    leaf into one workspace, each leaf at a fixed offset, then
    ``clip_finalize`` over all of it."""
    require_cuda("global_norm_scale", *grads)
    n_sm = _build.sm_count(grads[0].device.index)
    blocks = [sumsq_blocks(g.numel(), g.dtype, n_sm) for g in grads]
    partial = torch.empty(sum(blocks), dtype=torch.float32, device=grads[0].device)
    for g, piece in zip(grads, torch.split(partial, blocks)):
        sumsq_cuda(g, piece)
    return clip_finalize_cuda(partial, max_norm)


def global_norm_scale(grads: List[torch.Tensor],
                      max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(norm, scale) of global-norm clipping to ``max_norm``: the kernels
    for CUDA leaves, the plain version for CPU ones."""
    if grads[0].device.type == "cpu":
        return global_norm_scale_plain(grads, max_norm)
    return global_norm_scale_cuda(grads, max_norm)


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


def adamw_update(p, g, m, v, lr, c1, c2, scale=None, **hyper) -> None:
    """One leaf's AdamW update in place: the kernel for CUDA tensors, the
    plain version for CPU ones (arguments as :func:`adamw_update_cuda`)."""
    if p.device.type == "cpu":
        return adamw_update_plain(p, g, m, v, lr, c1, c2, scale, **hyper)
    return adamw_update_cuda(p, g, m, v, lr, c1, c2, scale, **hyper)
