"""Layers: RMSNorm, RoPE, GQA attention (with optional sliding window) and
DeepSeek's multi-head latent attention (MLA), each for prefill and decode,
and the SwiGLU MLP.

Counterpart of :mod:`repro.models.layers`, with the encoder-decoder's
cross attention, in the same functional style: ``*_init(gen, cfg, ...) -> params`` and ``*_apply(params, x, ...) ->
y``, with the same dict keys and ``x @ W`` layouts.
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


def cross_attn_apply(p, x, kv_cache, cfg: ModelConfig) -> torch.Tensor:
    """Cross attention against precomputed encoder K/V: x (B, S, D) ->
    (B, S, D); ``kv_cache`` = (k, v), each (B, Hkv, S_enc, hd). Every query
    sees every key (no mask, no RoPE), so Sq and S_enc differ freely."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k, v = kv_cache
    out = ops.flash_attention(q, k, v, causal=False, window=None)
    return out.transpose(1, 2).reshape(b, s, h * hd) @ p["wo"]


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
# MLA — DeepSeek-V3 multi-head latent attention
# --------------------------------------------------------------------------

def mla_init(gen, cfg: ModelConfig, dtype, device="cpu") -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wdq": dense_init(gen, d, cfg.q_lora_rank, dtype=dtype, device=device),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, device),
        "wuq": dense_init(gen, cfg.q_lora_rank, h * qk, dtype=dtype,
                          device=device),
        "wdkv": dense_init(gen, d, cfg.kv_lora_rank, dtype=dtype,
                           device=device),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, device),
        "wkr": dense_init(gen, d, cfg.qk_rope_head_dim, dtype=dtype,
                          device=device),
        "wukv": dense_init(gen, cfg.kv_lora_rank,
                           h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                           dtype=dtype, device=device),
        "wo": dense_init(gen, h * cfg.v_head_dim, d,
                         scale=(h * cfg.v_head_dim) ** -0.5
                         / (2 * cfg.n_layers) ** 0.5, dtype=dtype,
                         device=device),
    }


def _mla_qkv(p, x, cfg: ModelConfig, positions):
    """The queries and the compressed keys of x (B, S, D): q_nope (B, S, H,
    dn), q_rope (B, S, H, dr) with RoPE, c_kv (B, S, r_kv) normed, k_rope
    (B, S, 1, dr) with RoPE."""
    b, s, _ = x.shape
    cq = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(
        b, s, cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                             dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Full-sequence causal MLA, x: (B, S, D) -> (B, S, D). The keys are
    decompressed (k = [c_kv W_uk, k_rope] per head) and V is padded with
    zeros to the qk head width, so one flash-attention kernel of head dim
    qk (192 at DeepSeek-V3's widths) with scale qk^-0.5 computes it; the
    padding columns of its output are dropped."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    kv = (c_kv @ p["wukv"]).reshape(b, s, h, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    vp = F.pad(v, (0, dn + dr - dv))
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              vp.transpose(1, 2), causal=True, window=None,
                              scale=(dn + dr) ** -0.5)
    out = out.transpose(1, 2)[..., :dv]
    return out.reshape(b, s, h * dv) @ p["wo"]


def mla_make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device="cpu"):
    """Compressed cache: c_kv (B, S, r_kv) and k_rope (B, S, dr)."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the reference's type promotion: both operands
    in the wider of their dtypes (bf16 with float32 runs in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


def mla_decode(p, x, cache, pos: torch.Tensor, cfg: ModelConfig,
               absorbed: bool = True):
    """One-token MLA decode against the compressed cache. x: (B, D);
    ``pos``: absolute position, a 0-d integer tensor on x's device, never
    read on the host (as in :func:`attn_decode`). The new token's c_kv and
    k_rope are written into ``cache`` in place at slot ``pos`` by
    ``index_copy_``; keys at slots <= pos are attended (a mask built on the
    device). Returns (out (B, D), cache), the same cache dict.

    ``absorbed=True`` maps the queries into the latent space (q_nope W_uk)
    and attends over c_kv directly; ``absorbed=False`` decompresses the
    whole cache every step. Both are plain PyTorch einsums with the
    reference's dtypes (float32 over the cache), as the reference's are
    XLA einsums, not Pallas kernels."""
    b, _ = x.shape
    h, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x[:, None, :], cfg,
                                                    pos.view(1))
    slot = pos.long().view(1)
    cache["c_kv"].index_copy_(1, slot, c_kv_new.to(cache["c_kv"].dtype))
    cache["k_rope"].index_copy_(1, slot,
                                k_rope_new[:, :, 0].to(cache["k_rope"].dtype))
    scale = (dn + cfg.qk_rope_head_dim) ** -0.5
    s_max = cache["c_kv"].shape[1]
    valid = torch.arange(s_max, device=x.device) <= pos
    c_kv = cache["c_kv"].float()
    k_rope = cache["k_rope"].float()
    wukv = p["wukv"].reshape(cfg.kv_lora_rank, h, dn + dv)
    wk, wv = wukv[:, :, :dn], wukv[:, :, dn:]          # (r, h, dn), (r, h, dv)
    neg = torch.full((), -1e30, dtype=torch.float32, device=x.device)
    if absorbed:
        q_lat = _einsum("bhd,rhd->bhr", q_nope[:, 0], wk)
        logits = _einsum("bhr,bsr->bhs", q_lat, c_kv)
        logits = logits + _einsum("bhd,bsd->bhs", q_rope[:, 0], k_rope)
        logits = torch.where(valid[None, None], logits * scale, neg)
        w = torch.softmax(logits, dim=-1)
        o_lat = _einsum("bhs,bsr->bhr", w, c_kv)
        out = _einsum("bhr,rhd->bhd", o_lat, wv)
    else:
        kv = _einsum("bsr,rhd->bshd", c_kv, wukv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        logits = _einsum("bhd,bshd->bhs", q_nope[:, 0], k_nope)
        logits = logits + _einsum("bhd,bsd->bhs", q_rope[:, 0], k_rope)
        logits = torch.where(valid[None, None], logits * scale, neg)
        w = torch.softmax(logits, dim=-1)
        out = _einsum("bhs,bshd->bhd", w, v)
    out = out.to(x.dtype).reshape(b, h * dv)
    return out @ p["wo"], cache


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
