"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Counterpart of :mod:`repro.kernels.flash_attention`
(``flash_attention_pallas``). Causal, sliding-window or full masking, GQA
(q head h reads kv head h // G), ``offset`` placing q row 0, and ragged
``Sq``/``Skv`` masked inside the kernel. A CUDA tensor goes to the kernel, a
CPU tensor to :func:`flash_attention_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda, require_head_dim
from .ref import attention_ref as flash_attention_plain


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel. q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D), all
    contiguous, bf16 or f32 -> (B, Hq, Sq, D) in q's dtype."""
    require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,Hq,Sq,D), k = v "
                         f"(B,Hkv,Skv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype};"
                        f" want one of {list(DTYPE_CODES)} for all three")
    require_head_dim("flash_attention", d)
    if offset < 0:
        raise ValueError(f"flash_attention: offset {offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: k and v must be 16-byte aligned")
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty_like(q)
    if b == 0 or hq == 0 or sq == 0:
        return o
    if skv == 0:
        raise ValueError("flash_attention: empty key sequence")
    lib = _build.load()
    _build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, sq,
        skv, d, int(bool(causal)), -1 if window is None else int(window),
        int(offset), float(scale), DTYPE_CODES[q.dtype],
        _build.stream_handle(q)), "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, offset, scale)
    return flash_attention_cuda(q, k, v, causal, window, offset, scale)
