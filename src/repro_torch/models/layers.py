"""Dense layers: RMSNorm, RoPE, GQA attention (with optional sliding window)
for prefill and decode, and the SwiGLU MLP.

Counterpart of the dense part of :mod:`repro.models.layers`, in the same
functional style: ``*_init(gen, cfg, ...) -> params`` and
``*_apply(params, x, ...) -> y``, with the same dict keys and ``x @ W``
layouts. MLA comes with the MoE/MLA slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .config import ModelConfig
from .module import dense_init


def rmsnorm_init(d: int, device="cpu") -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x, scale, eps):
    return ops.rmsnorm(x, scale, eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with even D; positions: (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    if positions.dim() == 1:
        positions = positions[None]
    ang = positions[..., None].float() * freqs                  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention (with optional sliding window), prefill + decode
# --------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, dtype, device="cpu") -> Dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(gen, d, h * hd, dtype=dtype, device=device),
        "wk": dense_init(gen, d, hkv * hd, dtype=dtype, device=device),
        "wv": dense_init(gen, d, hkv * hd, dtype=dtype, device=device),
        "wo": dense_init(gen, h * hd, d,
                         scale=(h * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                         dtype=dtype, device=device),
    }


def attn_apply(p, x, cfg: ModelConfig, positions, causal=True,
               use_rope=True) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, D) -> (B, S, D).

    ``cfg.seq_shard`` asks for context-parallel attention, which the
    reference runs only under a mesh; the port has no mesh yet (ROADMAP.md,
    queue 1, item 6), so it runs plain flash attention, as the reference
    does without one."""
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # (B, H, S, D) views: the kernel reads them through their strides and
    # lays its output out as q is, so the reshape back to (B, S, H * D) is
    # free on the card
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=cfg.window)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ p["wo"]


def attn_make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device="cpu"):
    hkv, hd = cfg.n_kv_heads, cfg.hd
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, hkv, cache_len, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x, cache, pos: torch.Tensor, cfg: ModelConfig,
                use_rope=True):
    """One-token decode. x: (B, D); cache k/v: (B, Hkv, C, hd); ``pos``:
    absolute position, a 0-d integer tensor on x's device (the reference's
    traced ``jnp.int32``), never read on the host, so one CUDA graph of the
    step serves every position. Sliding windows use a ring buffer of width
    ``cfg.window``. Returns (out (B, D), cache).

    The new token's K/V are written into ``cache`` in place at slot ``pos``
    (``pos % C`` with a window) by ``index_copy_`` (the reference returns an
    updated copy); the returned cache is the same dict.
    """
    b, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, 1, h, hd)
    k = (x @ p["wk"]).reshape(b, 1, hkv, hd)
    v = (x @ p["wv"]).reshape(b, 1, hkv, hd)
    if use_rope:
        q = apply_rope(q, pos.view(1), cfg.rope_theta)
        k = apply_rope(k, pos.view(1), cfg.rope_theta)
    c = cache["k"].shape[2]
    slot = (pos % c if cfg.window else pos).long().view(1)
    cache["k"].index_copy_(2, slot, k.transpose(1, 2).to(cache["k"].dtype))
    cache["v"].index_copy_(2, slot, v.transpose(1, 2).to(cache["v"].dtype))
    length = torch.clamp(pos + 1, max=c).to(torch.int32).view(1).expand(b)
    # With a window ring buffer every slot < length is valid (all within the
    # last `window` positions), so no masking beyond `length` is needed.
    out = ops.decode_attention(q.reshape(b, h, hd), cache["k"], cache["v"],
                               length=length.contiguous())
    return out.reshape(b, h * hd) @ p["wo"], cache


# --------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# --------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, dtype, d_ff: int = None,
             device="cpu") -> Dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    return {"gate": dense_init(gen, d, d_ff, dtype=dtype, device=device),
            "up": dense_init(gen, d, d_ff, dtype=dtype, device=device),
            "down": dense_init(gen, d_ff, d,
                               scale=d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                               dtype=dtype, device=device)}


def mlp_apply(p, x) -> torch.Tensor:
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]
