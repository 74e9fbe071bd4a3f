"""Flash attention: the forward CUDA kernels ``csrc/flash_attention_sm90.cu``
(bf16, tensor cores) and ``csrc/flash_attention.cu`` (float32, CUDA cores),
the backward kernel ``csrc/flash_attention_bwd.cu`` (both dtypes), and their
plain versions.

Counterpart of :mod:`repro.kernels.flash_attention`
(``flash_attention_pallas``). Causal, sliding-window or full masking, GQA
(q head h reads kv head h // G), ``offset`` placing q row 0, and ragged
``Sq``/``Skv`` masked inside the kernel. The kernels read q, k, v and write o
through their batch, head and sequence strides, so (B, H, S, D) views of
(B, S, H, D) tensors need no copy. A CUDA tensor goes to the kernel of its
dtype, a CPU tensor to :func:`flash_attention_plain`. Where autograd needs a
gradient of a CUDA call, :class:`_FlashAttention` runs the forward kernel
and, for the backward, :func:`flash_attention_bwd_cuda` (plain version:
:func:`flash_attention_bwd_plain`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda, require_head_dim
from .ref import attention_bwd_ref as flash_attention_bwd_plain
from .ref import attention_ref as flash_attention_plain

# which kernel instance each dtype runs
INSTANCES = {torch.bfloat16: "wgmma", torch.float32: "simt"}


def _strides(name: str, t: torch.Tensor):
    """The batch, head and sequence strides of a (B, H, S, D) tensor, as the
    kernels take them: in elements, multiples of 16 bytes, the last dim
    contiguous. A dim of size 1 is never stepped over; it gets the stride a
    contiguous tensor would have. Raises ValueError otherwise."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s last dim must be contiguous "
                         f"(unit stride); strides {t.stride()}")
    align = 16 // t.element_size()
    dense = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
             t.shape[3])
    out = []
    for n, s, s_dense in zip(t.shape[:3], t.stride()[:3], dense):
        if n > 1 and (s <= 0 or s % align):
            raise ValueError(f"flash_attention: {name}'s strides {t.stride()} "
                             "must be positive multiples of 16 bytes")
        out.append(s if n > 1 else s_dense)
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    return (ctypes.c_longlong * 3)(*out)


def _check_args(q, k, v, window, offset, scale) -> float:
    """Shapes, dtypes, head dim and mask arguments of a forward or backward
    call; returns the softmax scale."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,Hq,Sq,D), k = v "
                         f"(B,Hkv,Skv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype};"
                        f" want one of {list(DTYPE_CODES)} for all three")
    require_head_dim("flash_attention", d, q.dtype)
    if offset < 0:
        raise ValueError(f"flash_attention: offset {offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    scale = scale if scale is not None else d ** -0.5
    if not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} must be positive (the "
                         "kernels take the row max of the unscaled logits)")
    return scale


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel of q's dtype (``INSTANCES``). q: (B, Hq, Sq, D);
    k/v: (B, Hkv, Skv, D), bf16 or f32, any strides with a contiguous last
    dim and 16-byte aligned rows -> (B, Hq, Sq, D) in q's dtype, laid out
    in memory as q is (``torch.empty_like``). The shapes, dtypes and strides
    are checked before the device."""
    scale = _check_args(q, k, v, window, offset, scale)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    strides = [_strides(name, t) for name, t in (("q", q), ("k", k), ("v", v))]
    require_cuda("flash_attention", q, k, v)
    o = torch.empty_like(q)
    if b == 0 or hq == 0 or sq == 0:
        return o
    if skv == 0:
        raise ValueError("flash_attention: empty key sequence")
    lib = _build.load()
    _build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *strides,
        _strides("o", o), b, hq, hkv, sq, skv, d, int(bool(causal)),
        -1 if window is None else int(window), int(offset), float(scale),
        DTYPE_CODES[q.dtype], _build.stream_handle(q)), "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def _bwd_strides(t: torch.Tensor):
    """Batch, head and sequence strides (elements) of a (B, H, S, D) tensor
    whose last dim is contiguous; the backward kernel reads element by
    element, so any other stride, zero included, works."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"flash_attention_bwd: last dim not contiguous, "
                         f"strides {t.stride()}")
    return list(t.stride()[:3])


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             window: Optional[int] = None, offset: int = 0,
                             scale: Optional[float] = None):
    """Launch the backward kernel (two launches, counted as one call):
    q, k, v and the forward's output o as the forward took and gave them,
    dO the gradient of o, of o's shape and dtype, read through its strides
    (one ``.contiguous()`` copy, counted in ``.copies``, when its last dim
    is not contiguous, as after a ``sum()``) -> (dq, dk, dv), each laid out
    in memory as q, k, v are."""
    scale = _check_args(q, k, v, window, offset, scale)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {o.dtype} {tuple(o.shape)} and"
                         f" dO {do.dtype} {tuple(do.shape)} must match q "
                         f"{q.dtype} {tuple(q.shape)}")
    require_cuda("flash_attention_bwd", q, k, v, o, do)
    if do.shape[-1] > 1 and do.stride(-1) != 1:
        do = do.contiguous()
        flash_attention_bwd_cuda.copies += 1
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0 or hq == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    if skv == 0:
        raise ValueError("flash_attention_bwd: empty key sequence")
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in _bwd_strides(t)))
    lib = _build.load()
    _build.check(lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), strides, b, hq, hkv, sq, skv, d, int(bool(causal)),
        -1 if window is None else int(window), int(offset), float(scale),
        DTYPE_CODES[q.dtype], _build.stream_handle(q)), "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.copies = 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, offset, scale):
        o = flash_attention_cuda(q, k, v, causal, window, offset, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (causal, window, offset, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The kernel for CUDA tensors (through :class:`_FlashAttention` when
    autograd needs their gradient), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, offset, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, offset, scale)
    return flash_attention_cuda(q, k, v, causal, window, offset, scale)
