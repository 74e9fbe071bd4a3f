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
from . import partitioning as part
from . import tensor_parallel as tp
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

    ``cfg.seq_shard`` asks for context-parallel attention: where the caller
    registered a token split over 'model' (``partitioning.use_mesh(...,
    seq_axis="model")``) of more than one rank, ``x`` is this rank's
    contiguous shard of S tokens, ``positions`` their absolute positions,
    and causal attention runs the ring (``ops.cp_flash_attention``; the
    reference's ``cp_flash_attention`` under a mesh whose 'model' axis
    divides S). With no token split registered every rank holds whole
    sequences and runs plain flash attention on them, as the reference
    does where 'model' does not divide S. ``seq_shard`` with projections
    split over 'model' raises NotImplementedError: the reference's only
    ``seq_shard`` config is ``pure_dp``. So does attention under a token
    split that the ring does not run (no ``seq_shard``, or not causal),
    which would see the rank's shard alone.

    Tensor parallelism (:mod:`.tensor_parallel`) is read from the leaves:
    a projection narrower than its whole width is this rank's slice over
    'model' (wq / wk / wv by columns, wo by rows). Where 'model' divides
    both head counts and slices every projection, each rank runs its heads
    (their GQA groups unchanged) and its rows of wo, and the ranks' outputs
    are summed. Otherwise (smollm's 15 / 5 heads at 2 ranks) every rank
    runs every head, as GSPMD does for the reference: wq / wk / wv gathered
    whole, then each rank's rows of wo on its columns of the attention
    output, summed over the ranks."""
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    split, own = attn_split(p, cfg)
    if cfg.seq_shard and any(split):
        raise NotImplementedError(
            f"{cfg.name}: seq_shard with projections split over 'model' "
            "(tensor parallelism); the reference runs seq_shard only with "
            "pure_dp")
    ring = part.seq_axis() is not None
    if ring and not (cfg.seq_shard and causal):
        raise NotImplementedError(
            f"{cfg.name}: attention under a token split over 'model' runs "
            "the ring, which takes causal attention of a seq_shard config "
            f"(seq_shard {cfg.seq_shard}, causal {causal})")
    cols = None
    if any(split):
        x = tp.copy_to_model(x)
        if own:
            h, hkv = h // tp.model_size(), hkv // tp.model_size()
        else:
            wq, wk, wv = every_head((wq, wk, wv), split)
            cols = slice(*tp.local_range(h * hd))
    q = (x @ wq).reshape(b, s, h, hd)
    k = (x @ wk).reshape(b, s, hkv, hd)
    v = (x @ wv).reshape(b, s, hkv, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # (B, H, S, D) views: the kernel reads them through their strides and
    # lays its output out as q is, so the reshape back to (B, S, H * D) is
    # free on the card
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if ring:
        out = ops.cp_flash_attention(qt, kt, vt, part.current_mesh(),
                                     part.seq_axis(), window=cfg.window)
    else:
        out = ops.flash_attention(qt, kt, vt, causal=causal, window=cfg.window)
    return _attn_out(out, p["wo"], split, cols)


def attn_split(p, cfg: ModelConfig):
    """How tensor parallelism splits an attention's leaves ``p`` (one
    layer's, or the decoder's stacked cross-attention ones: the widths are
    the last two dims): which of wq / wk / wv / wo hold this rank's slice
    over 'model' (wq / wk / wv by columns, wo by rows), and whether each
    rank runs its heads (``tensor_parallel.own_heads``) or every rank runs
    every head. wq and wo share the width h * hd, which 'model' divides
    wherever it divides wk's: a split leaves wq and wo split, wk / wv
    perhaps whole."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    split = (p["wq"].shape[-1] != h * hd, p["wk"].shape[-1] != hkv * hd,
             p["wv"].shape[-1] != hkv * hd, p["wo"].shape[-2] != h * hd)
    return split, tp.own_heads(split, h, hkv, tp.model_size())


def every_head(ws, split):
    """Projections ``ws`` whole on every rank, where every rank runs every
    head: a split one (its flag in ``split``) gathered over its columns,
    a whole one through ``copy_to_model``."""
    return tuple(tp.gather_from_model(w, w.dim() - 1) if sp
                 else tp.copy_to_model(w) for w, sp in zip(ws, split))


def _columns_whole(parts, split):
    """``parts`` (B, w) products, each this rank's columns over 'model'
    where ``split`` flags it, else whole -> each whole: the split ones'
    columns gathered in one all-gather of their concatenation (no
    gradient: serving)."""
    cut = [p for p, sp in zip(parts, split) if sp]
    if not cut:
        return parts
    widths = [p.shape[-1] for p in cut]
    b, m = cut[0].shape[0], tp.model_size()
    every = tp.gather_from_model(torch.cat(cut, dim=-1), -1).reshape(
        b, m, sum(widths)).split(widths, dim=-1)
    whole = iter(w.reshape(b, -1) for w in every)
    return [next(whole) if sp else p for p, sp in zip(parts, split)]


def _attn_out(out, wo, split, cols):
    """Attention's output (B, H, S, D), this rank's heads or every head,
    through wo: whole, or this rank's rows of wo (on its columns ``cols``
    of the output where it ran every head), summed over 'model'."""
    b, h, s, hd = out.shape
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    if cols is not None:
        out = out[..., cols]
    if not any(split):
        return out @ wo
    return tp.reduce_from_model(out @ wo)


def cross_attn_apply(p, x, kv_cache, cfg: ModelConfig) -> torch.Tensor:
    """Cross attention against precomputed encoder K/V: x (B, S, D) ->
    (B, S, D); ``kv_cache`` = (k, v), each (B, Hkv, S_enc, hd). Every query
    sees every key (no mask, no RoPE), so Sq and S_enc differ freely.

    Tensor parallelism is read from the leaves (:func:`attn_split`). Where
    each rank runs its heads, ``kv_cache`` holds the K/V of this rank's
    heads (``encdec.cross_kv``), q comes from its columns of wq and its
    output goes through its rows of wo. Otherwise every rank runs every
    head, as :func:`attn_apply` does: wq gathered whole (the K/V of every
    head), then each rank's columns of the attention output through its
    rows of wo. The ranks' outputs are summed."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    wq = p["wq"]
    split, own = attn_split(p, cfg)
    cols = None
    if any(split):
        x = tp.copy_to_model(x)
        if own:
            h //= tp.model_size()
        else:
            wq, = every_head((wq,), split)
            cols = slice(*tp.local_range(h * hd))
    q = (x @ wq).reshape(b, s, h, hd).transpose(1, 2)
    k, v = kv_cache
    out = ops.flash_attention(q, k, v, causal=False, window=None)
    return _attn_out(out, p["wo"], split, cols)


def cross_attn_decode(p, x, kv, cfg: ModelConfig) -> torch.Tensor:
    """One token's cross attention against the encoder's K/V: x (B, D) ->
    (B, D); ``kv`` = (k, v), each (B, Hkv, S_enc, hd), every slot valid,
    through the decode-attention kernel.

    Tensor parallelism is read from the leaves (:func:`attn_split`), as in
    :func:`cross_attn_apply`. The rules split these K/V by batch only
    (``launch.shardings.cache_pspec``), so every rank holds every head of
    its rows. Where each rank runs its heads, q comes from its columns of
    ``wq`` and attends over its heads of k / v (a slice the kernel reads
    in place), and its output goes through its rows of ``wo``. Otherwise
    every rank runs every head: the columns of x @ wq that a split wq gives
    each rank are gathered whole (a token's), then each rank's columns of
    the output go through its rows of ``wo``. The ranks' outputs are
    summed."""
    b, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k, v = kv
    split, own = attn_split(p, cfg)
    q, cols = x @ p["wq"], None
    if own:
        h //= tp.model_size()
        if k.shape[1] == hkv:
            lo, hi = tp.local_range(hkv)
            k, v = k[:, lo:hi], v[:, lo:hi]
    elif any(split):
        q, = _columns_whole([q], split[:1])
        cols = slice(*tp.local_range(h * hd))
    out = ops.decode_attention(q.reshape(b, h, hd), k, v)
    return _attn_out(out[:, :, None], p["wo"], split, cols)[:, 0]


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

    Under a mesh the cache holds this rank's slice in one of the layouts of
    ``launch.shardings.cache_pspec`` (the batch rows are the step's):
    (a) the KV heads over 'model' (fewer than ``cfg.n_kv_heads`` here):
    each rank runs its heads and its rows of wo (sliced here where the
    leaves are whole), and the ranks' outputs are summed, as in
    :func:`attn_apply`; (b) the length over 'model' and (c) with batch 1
    the length over every axis (``partitioning.cache_axes()``): every rank
    runs every head, the columns of x @ wq / wk / wv that split leaves
    give each rank gathered whole in one all-gather (one token a row: the
    products are far smaller than the weights that :func:`every_head`
    would gather), only the rank whose slice holds the slot writes the new
    K/V (the
    others write their old values back), each attends over its valid
    slots, clamp(min(pos + 1, C) - r C / M, 0, C / M) of its C / M, with
    its log-sum-exp, and the ranks combine
    (``tensor_parallel.combine_partials``); then its rows of a split wo
    on its columns of the output, summed over 'model'."""
    b, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wq, wk, wv, wo = p["wq"], p["wk"], p["wv"], p["wo"]
    split, _ = attn_split(p, cfg)
    cols, summed = None, any(split)
    local_heads = cache["k"].shape[1]
    own = local_heads != hkv
    if own:                                     # (a) this rank's KV heads
        g = h // hkv
        lo, hi = tp.local_range(hkv)
        q_cols, kv_cols = slice(lo * g * hd, hi * g * hd), slice(lo * hd, hi * hd)
        wq = wq if split[0] else wq[:, q_cols]
        wk = wk if split[1] else wk[:, kv_cols]
        wv = wv if split[2] else wv[:, kv_cols]
        wo = wo if split[3] else wo[q_cols]
        h, hkv, summed = h // hkv * local_heads, local_heads, True
    elif split[3]:
        cols = slice(*tp.local_range(h * hd))
    q, k, v = _columns_whole([x @ w for w in (wq, wk, wv)],
                             (False,) * 3 if own else split[:3])
    q = q.reshape(b, 1, h, hd)
    k = k.reshape(b, 1, hkv, hd)
    v = v.reshape(b, 1, hkv, hd)
    if use_rope:
        q = apply_rope(q, pos.view(1), cfg.rope_theta)
        k = apply_rope(k, pos.view(1), cfg.rope_theta)
    c = cache["k"].shape[2]
    axes = part.cache_axes()
    r, n = part.cache_index()
    whole = c * n
    slot = (pos % whole if cfg.window else pos).long().view(1)
    k, v = k.transpose(1, 2).to(cache["k"].dtype), v.transpose(1, 2).to(cache["v"].dtype)
    _owned_write(cache["k"], 2, slot, k, axes, r)
    _owned_write(cache["v"], 2, slot, v, axes, r)
    # With a window ring buffer every slot < length is valid (all within the
    # last `window` positions), so no masking beyond `length` is needed.
    length = torch.clamp(pos + 1, max=whole)
    if axes:
        length = torch.clamp(length - r * c, 0, c)
    length = length.to(torch.int32).view(1).expand(b).contiguous()
    qd = q.reshape(b, h, hd)
    if axes:
        out, lse = ops.decode_attention(qd, cache["k"], cache["v"],
                                        length=length, return_lse=True)
        out = tp.combine_partials(out, lse, axes)
    else:
        out = ops.decode_attention(qd, cache["k"], cache["v"], length=length)
    out = out.reshape(b, h * hd)
    if cols is not None:
        out = out[..., cols]
    out = out @ wo
    return (tp.reduce_from_model(out) if summed else out), cache


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


def _latent(x, w, scale, width: int, eps):
    """RMSNorm of the latent ``x @ w`` of ``width`` columns. Where ``w``
    holds this rank's columns of it over 'model', the product's columns are
    gathered first: the norm reads whole rows."""
    y = x @ w
    if w.shape[1] != width:
        y = tp.gather_from_model(y, -1)
    return rmsnorm(y, scale, eps)


def _mla_qkv(p, x, cfg: ModelConfig, positions):
    """The queries and the compressed keys of x (B, S, D): q_nope (B, S, H,
    dn), q_rope (B, S, H, dr) with RoPE, c_kv (B, S, r_kv) normed, k_rope
    (B, S, 1, dr) with RoPE. H is the number of heads that ``wuq`` holds
    (this rank's under tensor parallelism); ``wdq`` / ``wdkv`` may hold this
    rank's columns of the latents (:func:`_latent`)."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = _latent(x, p["wdq"], p["q_norm"], cfg.q_lora_rank, cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(b, s, -1, dn + dr)
    q_nope, q_rope = q.split([dn, dr], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = _latent(x, p["wdkv"], p["kv_norm"], cfg.kv_lora_rank, cfg.norm_eps)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Full-sequence causal MLA, x: (B, S, D) -> (B, S, D). The keys are
    decompressed (k = [c_kv W_uk, k_rope] per head) and V is padded with
    zeros to the qk head width, so one flash-attention kernel of head dim
    qk (192 at DeepSeek-V3's widths) with scale qk^-0.5 computes it; the
    padding columns of its output are dropped.

    Tensor parallelism (:mod:`.tensor_parallel`) is read from the leaves,
    as in :func:`attn_apply`: ``wdq`` / ``wdkv`` / ``wuq`` / ``wukv``
    narrower than their whole width hold this rank's columns over 'model',
    ``wo`` its rows. The latents' columns are gathered before their norms
    (:func:`_latent`). Where 'model' divides the heads and slices wuq,
    wukv and wo, each rank runs its heads (their columns are contiguous);
    otherwise wuq / wukv are gathered whole and every rank runs every
    head, then its columns of the output. Its rows of wo follow, and the
    ranks' outputs are summed. ``x`` and every leaf that stays whole
    (``wkr``, the norms, an unsplit down projection) enter this rank's
    work through ``copy_to_model``, so each takes its whole gradient. A
    split that leaves ``wo`` whole raises NotImplementedError."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    widths = {"wdq": cfg.q_lora_rank, "wdkv": cfg.kv_lora_rank,
              "wuq": h * (dn + dr), "wukv": h * (dn + dv)}
    split = {k: p[k].shape[1] != n for k, n in widths.items()}
    split_wo = p["wo"].shape[0] != h * dv
    if any(split.values()) and not split_wo:
        raise NotImplementedError(
            f"{cfg.name}: MLA with {sorted(k for k in split if split[k])} "
            "split over 'model' and wo whole")
    cols = None
    if split_wo:
        m = tp.model_size()
        x = tp.copy_to_model(x)
        p = dict(p)
        for k in ("wkr", "q_norm", "kv_norm", "wdq", "wdkv"):
            if not split.get(k):
                p[k] = tp.copy_to_model(p[k])
        if split["wuq"] and split["wukv"] and h % m == 0:
            h //= m                                 # this rank's heads
        else:                                       # every head on every rank
            for k in ("wuq", "wukv"):
                p[k] = tp.gather_from_model(p[k], 1) if split[k] \
                    else tp.copy_to_model(p[k])
            cols = slice(*tp.local_range(h * dv))
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    kv = (c_kv @ p["wukv"]).reshape(b, s, h, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    vp = F.pad(v, (0, dn + dr - dv))
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              vp.transpose(1, 2), causal=True, window=None,
                              scale=(dn + dr) ** -0.5)
    out = out.transpose(1, 2)[..., :dv].reshape(b, s, h * dv)
    if cols is not None:
        out = out[..., cols]
    out = out @ p["wo"]
    return tp.reduce_from_model(out) if split_wo else out


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


def _owned_write(cache, dim: int, slot, new, axes, r: int):
    """``new`` written at ``slot`` of dim ``dim`` of ``cache`` in place
    (``index_copy_``). Under a split of that dim over ``axes`` (rank ``r``
    of them holding slots [r C, (r + 1) C)) only the rank that holds the
    slot writes it; the others write their old values back."""
    if axes:
        c = cache.shape[dim]
        local = slot - r * c
        owned = (local >= 0) & (local < c)
        slot = torch.clamp(local, 0, c - 1)
        new = torch.where(owned, new, cache.index_select(dim, slot))
    cache.index_copy_(dim, slot, new)


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
    XLA einsums, not Pallas kernels.

    Under tensor parallelism (the leaves split as in :func:`mla_apply`:
    each rank its heads) the cache holds this rank's slice of its length,
    over 'model' or with batch 1 over ('data', 'model')
    (``partitioning.cache_axes()``), and every rank attends over its own
    slots for every head, as the heads share the latent. Each rank
    computes q of its heads (its columns of ``wuq``) and q_lat = q_nope
    W_uk (its columns of ``wukv``); q_lat and q_rope are gathered over
    'model' (a token's, (B, H, r + dr)). The new token's latents are whole
    on every rank (gathered before their norms); the slot's holder writes
    them, the others write their old values back. Each rank's softmax
    over its valid slots gives its o_lat (B, H, r) with its log-sum-exp,
    and the ranks combine (``tensor_parallel.combine_partials``); its
    heads of o_lat go through W_uv and its rows of ``wo``, summed over
    'model'. ``absorbed=False`` would need every head's W_uk / W_uv on
    every rank and raises NotImplementedError under a split; so does a
    split that leaves the heads whole (as :func:`mla_apply` raises)."""
    b, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    r_kv = cfg.kv_lora_rank
    widths = {"wdq": cfg.q_lora_rank, "wdkv": r_kv, "wuq": h * (dn + dr),
              "wukv": h * (dn + dv)}
    split = {k: p[k].shape[1] != n for k, n in widths.items()}
    split_wo = p["wo"].shape[0] != h * dv
    if any(split.values()) and not (split_wo and split["wuq"] and
                                    split["wukv"] and h % tp.model_size() == 0):
        raise NotImplementedError(
            f"{cfg.name}: MLA decode with {sorted(k for k in split if split[k])}"
            f" split over 'model' (wo split {split_wo}) does not give each "
            f"rank its heads of {h}")
    axes = part.cache_axes()
    if (split_wo or axes) and not absorbed:
        raise NotImplementedError(
            f"{cfg.name}: MLA decode with absorbed=False under a split over "
            "'model' or of the cache's length: it decompresses the cache "
            "with every head's W_uk / W_uv")
    hl = p["wuq"].shape[1] // (dn + dr)                 # this rank's heads
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x[:, None, :], cfg,
                                                    pos.view(1))
    slot = pos.long().view(1)
    rank, _ = part.cache_index()
    _owned_write(cache["c_kv"], 1, slot, c_kv_new.to(cache["c_kv"].dtype),
                 axes, rank)
    _owned_write(cache["k_rope"], 1, slot,
                 k_rope_new[:, :, 0].to(cache["k_rope"].dtype), axes, rank)
    scale = (dn + dr) ** -0.5
    s_max = cache["c_kv"].shape[1]
    valid = torch.arange(s_max, device=x.device) + rank * s_max <= pos
    c_kv = cache["c_kv"].float()
    k_rope = cache["k_rope"].float()
    wukv = p["wukv"].reshape(r_kv, hl, dn + dv)
    wk, wv = wukv[:, :, :dn], wukv[:, :, dn:]          # (r, h, dn), (r, h, dv)
    neg = torch.full((), -1e30, dtype=torch.float32, device=x.device)
    if absorbed:
        q_lat = _einsum("bhd,rhd->bhr", q_nope[:, 0], wk)
        q_rope = q_rope[:, 0]
        if split_wo:                          # every head's queries
            both = tp.gather_from_model(
                torch.cat([q_lat, q_rope.to(q_lat.dtype)], dim=-1), 1)
            q_lat, q_rope = both.split([r_kv, dr], dim=-1)
        logits = _einsum("bhr,bsr->bhs", q_lat, c_kv)
        logits = logits + _einsum("bhd,bsd->bhs", q_rope, k_rope)
        if axes:
            logits = torch.where(valid[None, None], logits * scale,
                                 float("-inf"))
            lse = torch.logsumexp(logits, dim=-1)
            w = torch.exp(logits - torch.where(torch.isfinite(lse), lse,
                                               0.0)[..., None])
            o_lat = tp.combine_partials(_einsum("bhs,bsr->bhr", w, c_kv),
                                        lse, axes)
        else:
            logits = torch.where(valid[None, None], logits * scale, neg)
            w = torch.softmax(logits, dim=-1)
            o_lat = _einsum("bhs,bsr->bhr", w, c_kv)
        if split_wo:                          # this rank's heads
            lo = tp.model_index() * hl
            o_lat = o_lat[:, lo:lo + hl]
        out = _einsum("bhr,rhd->bhd", o_lat, wv)
    else:
        kv = _einsum("bsr,rhd->bshd", c_kv, wukv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        logits = _einsum("bhd,bshd->bhs", q_nope[:, 0], k_nope)
        logits = logits + _einsum("bhd,bsd->bhs", q_rope[:, 0], k_rope)
        logits = torch.where(valid[None, None], logits * scale, neg)
        w = torch.softmax(logits, dim=-1)
        out = _einsum("bhs,bshd->bhd", w, v)
    out = out.to(x.dtype).reshape(b, hl * dv) @ p["wo"]
    return (tp.reduce_from_model(out) if split_wo else out), cache


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


def mlp_apply(p, x, width: int = None) -> torch.Tensor:
    """SwiGLU. ``width``: the hidden width of the whole MLP; where gate is
    narrower, gate / up hold this rank's columns and down its rows over
    'model' (:mod:`.tensor_parallel`), and the ranks' outputs are summed.
    Without ``width`` the leaves are taken whole."""
    if width is None or p["gate"].shape[-1] == width:
        return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]
    x = tp.copy_to_model(x)
    return tp.reduce_from_model(
        (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"])
