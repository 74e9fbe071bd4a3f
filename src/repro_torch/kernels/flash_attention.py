"""Flash attention: the forward CUDA kernels ``csrc/flash_attention_sm90.cu``
(bf16, tensor cores; it can also write each row's log-sum-exp L) and
``csrc/flash_attention.cu`` (float32, CUDA cores), the backward kernels
``csrc/flash_attention_bwd_sm90.cu`` (bf16, tensor cores, reading L) and
``csrc/flash_attention_bwd.cu`` (float32, CUDA cores, computing L itself),
and their plain versions.

Counterpart of :mod:`repro.kernels.flash_attention`
(``flash_attention_pallas``). Causal, sliding-window or full masking, GQA
(q head h reads kv head h // G), ``offset`` placing q row 0, and ragged
``Sq``/``Skv`` masked inside the kernel. The kernels read q, k, v and write o
through their batch, head and sequence strides, so (B, H, S, D) views of
(B, S, H, D) tensors need no copy. A CUDA tensor goes to the kernel of its
dtype, a CPU tensor to :func:`flash_attention_plain`. Where autograd needs a
gradient of a CUDA call, :class:`_FlashAttention` runs the forward kernel
and, for the backward, :func:`flash_attention_bwd_cuda` (plain version:
:func:`flash_attention_bwd_plain`). L follows the convention
``P = exp(scale * s - L)``, +inf for a row that sees no key.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda, require_head_dim
from .ref import attention_bwd_ref as flash_attention_bwd_plain
from .ref import attention_ref as flash_attention_plain

# which kernel instance each dtype runs, forward and backward: bf16 on the
# tensor cores, float32 on the CUDA cores
INSTANCES = {torch.bfloat16: "wgmma", torch.float32: "simt"}


def _stride_error(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot read ``t`` through its strides (the last dim
    contiguous, the others positive multiples of 16 bytes, the base 16-byte
    aligned: what TMA and 16-byte loads take), or None."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return (f"flash_attention: {name}'s last dim must be contiguous "
                f"(unit stride); strides {t.stride()}")
    align = 16 // t.element_size()
    for n, s in zip(t.shape[:3], t.stride()[:3]):
        if n > 1 and (s <= 0 or s % align):
            return (f"flash_attention: {name}'s strides {t.stride()} must be "
                    "positive multiples of 16 bytes")
    if t.data_ptr() % 16:
        return f"flash_attention: {name} must be 16-byte aligned"
    return None


def _strides(name: str, t: torch.Tensor):
    """The batch, head and sequence strides of a (B, H, S, D) tensor, as the
    kernels take them: in elements. A dim of size 1 is never stepped over;
    it gets the stride a contiguous tensor would have. Raises ValueError
    where :func:`_stride_error` finds a fault."""
    err = _stride_error(name, t)
    if err:
        raise ValueError(err)
    dense = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
             t.shape[3])
    return [s if n > 1 else s_dense
            for n, s, s_dense in zip(t.shape[:3], t.stride()[:3], dense)]


def _check_args(q, k, v, window, offset, scale,
                kernel: str = "flash_attention") -> float:
    """Shapes, dtypes, head dim (of ``kernel``'s instances) and mask
    arguments of a forward or backward call; returns the softmax scale."""
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
    require_head_dim(kernel, d, q.dtype)
    if offset < 0:
        raise ValueError(f"flash_attention: offset {offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    scale = scale if scale is not None else d ** -0.5
    if not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} must be positive (the "
                         "kernels take the row max of the unscaled logits)")
    return scale


def _c_strides(*tensors):
    """The strides of each (name, tensor) pair, flattened for the C entry."""
    flat = [s for name, t in tensors for s in _strides(name, t)]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         offset: int = 0, scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the kernel of q's dtype (``INSTANCES``). q: (B, Hq, Sq, D);
    k/v: (B, Hkv, Skv, D), bf16 or f32, any strides with a contiguous last
    dim and 16-byte aligned rows -> (B, Hq, Sq, D) in q's dtype, laid out
    in memory as q is (``torch.empty_like``). With ``return_lse`` (bf16
    only) -> (o, L), L the (B, Hq, Sq) float32 log-sum-exp of each row's
    scaled, masked logits (+inf for a row that sees no key), written by the
    same launch. The shapes, dtypes and strides are checked before the
    device."""
    scale = _check_args(q, k, v, window, offset, scale)
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: only the bf16 kernel writes the "
                         f"log-sum-exp; got {q.dtype}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    strides = [_c_strides((name, t)) for name, t in (("q", q), ("k", k), ("v", v))]
    require_cuda("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or hq == 0 or sq == 0:
        return (o, lse) if return_lse else o
    if skv == 0:
        raise ValueError("flash_attention: empty key sequence")
    lib = _build.load()
    _build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *strides, _c_strides(("o", o)), b, hq, hkv, sq, skv, d, int(bool(causal)),
        -1 if window is None else int(window), int(offset), float(scale),
        DTYPE_CODES[q.dtype], _build.stream_handle(q)), "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0


def _bwd_strides(t: torch.Tensor):
    """Batch, head and sequence strides (elements) of a (B, H, S, D) tensor
    whose last dim is contiguous; the CUDA-core backward reads element by
    element, so any other stride, zero included, works."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"flash_attention_bwd: last dim not contiguous, "
                         f"strides {t.stride()}")
    return list(t.stride()[:3])


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             window: Optional[int] = None, offset: int = 0,
                             scale: Optional[float] = None,
                             lse: Optional[torch.Tensor] = None):
    """Launch the backward kernel of q's dtype (``INSTANCES``; two
    launches, counted as one call): q, k, v and the forward's output o as
    the forward took and gave them, dO the gradient of o, of o's shape and
    dtype -> (dq, dk, dv), each laid out in memory as q, k, v are.

    bf16 (``wgmma``) reads each row's log-sum-exp ``lse``, (B, Hq, Sq)
    float32 contiguous, as ``flash_attention_cuda(..., return_lse=True)``
    gives it; without one it runs that forward once more for it (counted in
    ``.lse_forwards``). It reads dO through its strides, or through one
    ``.contiguous()`` copy (counted in ``.copies``) where TMA cannot (a
    stride 0, as after a ``sum()``, or one off 16 bytes). float32
    (``simt``) computes L itself and ignores ``lse``; it copies dO only
    when its last dim is not contiguous. A head dim with no backward
    instance (``_checks.HEAD_DIMS``) raises NotImplementedError before any
    launch."""
    scale = _check_args(q, k, v, window, offset, scale, "flash_attention_bwd")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {o.dtype} {tuple(o.shape)} and"
                         f" dO {do.dtype} {tuple(do.shape)} must match q "
                         f"{q.dtype} {tuple(q.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if lse is not None and (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 of "
                         f"shape {(b, hq, sq)}; got {lse.dtype} {tuple(lse.shape)} "
                         f"strides {lse.stride()}")
    wgmma = INSTANCES[q.dtype] == "wgmma"
    if wgmma:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
            _strides(name, t)
    require_cuda("flash_attention_bwd", q, k, v, o, do,
                 *(() if lse is None else (lse,)))
    if (_stride_error("dO", do) if wgmma
            else do.shape[-1] > 1 and do.stride(-1) != 1):
        do = do.contiguous()
        flash_attention_bwd_cuda.copies += 1
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0 or hq == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    if skv == 0:
        raise ValueError("flash_attention_bwd: empty key sequence")
    if wgmma and lse is None:
        _, lse = flash_attention_cuda(q, k, v, causal, window, offset, scale,
                                      return_lse=True)
        flash_attention_bwd_cuda.lse_forwards += 1
    if not wgmma:
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    tensors = (("q", q), ("k", k), ("v", v), ("o", o), ("dO", do), ("dq", dq),
               ("dk", dk), ("dv", dv))
    lib = _build.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    mask = (b, hq, hkv, sq, skv, d, int(bool(causal)),
            -1 if window is None else int(window), int(offset), float(scale))
    if wgmma:
        _build.check(lib.flash_attention_bwd_wgmma(
            *args, _c_strides(*tensors), *mask, _build.stream_handle(q)),
            "flash_attention_bwd_wgmma")
    else:
        strides = (ctypes.c_longlong * 24)(*(
            s for _, t in tensors for s in _bwd_strides(t)))
        _build.check(lib.flash_attention_bwd(
            *args, strides, *mask, DTYPE_CODES[q.dtype], _build.stream_handle(q)),
            "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.copies = 0
flash_attention_bwd_cuda.lse_forwards = 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the backward kernel for its gradient; the bf16
    forward also writes the log-sum-exp its backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, offset, scale):
        lse = None
        if INSTANCES[q.dtype] == "wgmma":
            o, lse = flash_attention_cuda(q, k, v, causal, window, offset, scale,
                                          return_lse=True)
        else:
            o = flash_attention_cuda(q, k, v, causal, window, offset, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, offset, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, *ctx.args, lse=lse)
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
