"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its
plain version.

Counterpart of :mod:`repro.kernels.decode_attention`
(``decode_attention_pallas``): one query token per sequence against a KV
cache, masked to ``kpos < length[b]``. ``window`` is applied as
``decode_attention_ref`` applies it (the Pallas kernel ignores it). A CUDA
tensor goes to the kernel, a CPU tensor to :func:`decode_attention_plain`.
The kernel splits the cache over several blocks (:func:`split_plan`) and
combines their partial results in the same launch. With ``return_lse`` it
also writes each row's log-sum-exp L, by which ranks that each hold a
part of the cache combine their partial outputs
(``tensor_parallel.combine_partials``). The kernel is an operator
(``repro_torch::decode_attention``, see ``_checks``), counted as 4 D flops
a slot a q head over every slot (a shape-only count: the valid lengths are
data).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ._checks import (DTYPE_CODES, plain, require_cuda, require_head_dim,
                      require_no_grad)
from .ref import decode_attention_ref as decode_attention_plain

# The splits of one (batch, kv head, tile of q heads) form a thread-block
# cluster; 8 blocks is the portable cluster size.
MAX_SPLITS = 8
# no split shorter than this many keys (a block walks 16-64 keys per step)
MIN_CHUNK = 32
# a longer cache takes more splits up to the cap, at most this many keys each
LONG_CHUNK = 512
# query rows of one kv head that a block serves (the kernel's kRows)
ROWS_PER_BLOCK = 4


def split_plan(b: int, hkv: int, g: int, s: int, n_sm: int) -> Tuple[int, int]:
    """(n_split, chunk): the cache of S keys cut into ``n_split`` chunks of
    ``chunk`` keys, the last one shorter, none empty. Enough splits that
    the grid (b * hkv * ceil(g / ROWS_PER_BLOCK) * n_split blocks) covers
    ``n_sm`` SMs, or that no chunk is longer than LONG_CHUNK keys; at most
    MAX_SPLITS, and no chunk shorter than MIN_CHUNK keys unless S is. Pure:
    S and the SM count only, never the device-side ``length``."""
    if min(b, hkv, g, s, n_sm) < 1:
        raise ValueError(f"split_plan: b={b} hkv={hkv} g={g} s={s} n_sm={n_sm}")
    pairs = b * hkv * -(-g // ROWS_PER_BLOCK)
    want = max(-(-n_sm // pairs), -(-s // LONG_CHUNK))
    n = max(1, min(MAX_SPLITS, want, -(-s // MIN_CHUNK)))
    chunk = -(-s // n)
    return -(-s // chunk), chunk


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: Optional[torch.Tensor] = None,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Launch the kernel. q: (B, Hq, D); k/v: (B, Hkv, S, D), contiguous
    (or a slice of the heads of a contiguous (B, H, S, D), as a rank's
    heads of a cache: every row of Hkv heads at a batch stride of H S D
    elements) and 16-byte aligned, bf16 or f32; length: (B,) int32 on the
    same device
    (None: all S valid; the kernel then reads no length) -> (B, Hq, D) in
    q's dtype; with ``return_lse`` (o, L), L (B, Hq) float32, -inf for a
    row with no valid slot (its output 0), written by the same launch."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: want q (B,Hq,D), k = v "
                         f"(B,Hkv,S,D); got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    given = () if length is None else (length,)
    require_cuda("decode_attention", q, k, v, *given)
    if k.shape[0] != b or k.shape[3] != d or hq % hkv or s == 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not match"
                         f" k/v {tuple(k.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; want one of {list(DTYPE_CODES)} for all")
    if length is not None and (length.dtype != torch.int32
                               or tuple(length.shape) != (b,)):
        raise ValueError(f"decode_attention: length must be int32 ({b},), got"
                         f" {length.dtype} {tuple(length.shape)}")
    require_head_dim("decode_attention", d, q.dtype)
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    kv_heads = heads_in_memory(k)
    if not all(t.is_contiguous() for t in (q, *given)) or \
            kv_heads is None or heads_in_memory(v) != kv_heads:
        raise ValueError("decode_attention: q and length must be contiguous, "
                         "k and v contiguous or slices of one batch stride "
                         "of a contiguous cache's heads")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q, k and v must be 16-byte "
                         "aligned (the kernel reads rows in 16-byte vectors)")
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0:
        return (o, lse) if return_lse else o
    n_split, chunk = split_plan(b, hkv, hq // hkv, s, _build.sm_count(q.device.index))
    lib = _build.load()
    _build.check(lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if length is None else length.data_ptr(),
        o.data_ptr(), None if lse is None else lse.data_ptr(),
        b, hq, hkv, kv_heads, s, d, n_split, chunk,
        -1 if window is None else int(window), float(scale),
        DTYPE_CODES[q.dtype], _build.stream_handle(q)),
        "decode_attention_fwd")
    decode_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


decode_attention_cuda.launches = 0


def heads_in_memory(t: torch.Tensor) -> Optional[int]:
    """H, where ``t`` (B, Hkv, S, D) is Hkv consecutive heads of each row of
    a contiguous (B, H, S, D), H >= Hkv (Hkv itself where ``t`` is
    contiguous); None for any other layout."""
    b, hkv, s, d = t.shape
    if t.is_contiguous():
        return hkv
    if t[0].is_contiguous() and t.stride(0) % (s * d) == 0 and \
            t.stride(0) >= hkv * s * d:
        return t.stride(0) // (s * d)
    return None


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cuda")
def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        length: Optional[torch.Tensor], window: Optional[int],
                        scale: Optional[float], with_lse: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel as an operator: (o, L), L empty unless ``with_lse``."""
    if with_lse:
        return decode_attention_cuda(q, k, v, length, window, scale, True)
    return (decode_attention_cuda(q, k, v, length, window, scale),
            q.new_empty((0,), dtype=torch.float32))


@decode_attention_op.register_kernel("cpu")
def _(q, k, v, length, window, scale, with_lse):
    if with_lse:
        return decode_attention_plain(q, k, v, length, window, scale, True)
    return (decode_attention_plain(q, k, v, length, window, scale),
            q.new_empty((0,), dtype=torch.float32))


@decode_attention_op.register_fake
def _(q, k, v, length, window, scale, with_lse):
    return torch.empty_like(q), q.new_empty(
        q.shape[:2] if with_lse else (0,), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.decode_attention, get_raw=True)
def _(q, k, *args, out_val=None, **kwargs) -> int:
    b, hq, d = q.shape
    return 4 * b * hq * d * k.shape[2]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Optional[torch.Tensor] = None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None, return_lse: bool = False):
    """The plain version for real CPU tensors, the operator otherwise. The
    kernel has no backward (serving only): on the card a call that autograd
    would need a gradient of raises. With ``return_lse`` -> (o, L)."""
    if plain("decode_attention", q):
        return decode_attention_plain(q, k, v, length, window, scale,
                                      return_lse)
    require_no_grad("decode_attention", q, k, v)
    o, lse = decode_attention_op(q, k, v, length, window, scale, return_lse)
    return (o, lse) if return_lse else o
