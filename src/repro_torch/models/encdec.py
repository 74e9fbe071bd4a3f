"""Whisper-style encoder-decoder (audio frontend stubbed).

Counterpart of :mod:`repro.models.encdec`, with its parameter tree (stacked
``encoder`` / ``decoder`` leaves with a leading layer axis, learned
``enc_pos`` / ``dec_pos``, the head tied to the embedding). The encoder is a
bidirectional transformer over precomputed frame embeddings (B, enc_seq,
D); the decoder adds causal self-attention (a KV cache when decoding) and
cross-attention over the encoder states, whose K/V every decoder layer
computes once (``cross_kv``). Neither side takes RoPE.

Entry points:
  init(gen, cfg, device)                         -> params
  encode(params, frames, cfg)                    -> encoder states
  cross_kv(params, enc_states, cfg)              -> (k, v) of every layer
  decode_train(params, enc_states, tokens, cfg)  -> hidden
  lm_loss(params, batch, cfg)                    -> (loss, metrics)
  init_cache(cfg, batch, max_len, enc_states, params, device) -> cache
  decode_step(params, cache, tokens, pos, cfg)   -> (logits, cache)

Where the reference scans over the layer axis the port loops in Python; each
stacked leaf is taken apart once (``transformer._unstack``) outside the
checkpointed layers, so its gradient is written once.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import ops
from . import layers as L
from .config import ModelConfig
from .module import embed_init, normal_init, stack_init, tree_map
from .transformer import _chunked_ce, _dtype, _layer, _unstack

Params = Dict[str, Any]


def _enc_block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "attn": L.attn_init(gen, cfg, dtype, device),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "mlp": L.mlp_init(gen, cfg, dtype, device=device)}


def _dec_block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "self": L.attn_init(gen, cfg, dtype, device),
            "ln_x": L.rmsnorm_init(cfg.d_model, device),
            "cross": L.attn_init(gen, cfg, dtype, device),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "mlp": L.mlp_init(gen, cfg, dtype, device=device)}


def init(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random parameters drawn from ``gen`` (on the generator's device, or
    nowhere for ``device="meta"``) and placed on ``device``."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device=dev),
        "enc_pos": normal_init(gen, (cfg.encoder_seq, cfg.d_model), 0.02,
                               dtype, dev),
        "dec_pos": normal_init(gen, (cfg.max_seq, cfg.d_model), 0.02, dtype,
                               dev),
        "encoder": stack_init(lambda g: _enc_block_init(g, cfg, dtype, dev),
                              gen, cfg.encoder_layers),
        "decoder": stack_init(lambda g: _dec_block_init(g, cfg, dtype, dev),
                              gen, cfg.n_layers),
        "enc_norm": L.rmsnorm_init(cfg.d_model, dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, dev),
    }
    # the decoder's head is the embedding (Whisper style)
    return params


def _remat(body, *args):
    """``body(*args)`` under ``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` with nothing saveable: only the inputs are kept and
    the body runs again in the backward pass. No RNG state is stashed (the
    model draws none), so the step stays capturable in a CUDA graph."""
    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False)


def encode(params, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, enc_seq, D) stub embeddings -> encoder states (B,
    enc_seq, D): non-causal attention, no RoPE, then ``enc_norm``."""
    x = frames.to(_dtype(cfg)) + params["enc_pos"][None]
    positions = torch.arange(frames.shape[1], device=x.device)

    def body(x, bp):
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        x = x + L.attn_apply(bp["attn"], h, cfg, positions, causal=False,
                             use_rope=False)
        h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + L.mlp_apply(bp["mlp"], h)

    remat = cfg.remat and torch.is_grad_enabled()
    for bp in _unstack(params["encoder"], cfg.encoder_layers):
        x = _remat(body, x, bp) if remat else body(x, bp)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _kv_all_layers(x: torch.Tensor, w: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) through every layer's projection w (L, D, Hkv * hd) in
    one product -> (L, B, Hkv, S, hd), contiguous."""
    n, d, e = w.shape
    b, s, _ = x.shape
    y = x.reshape(b * s, d) @ w.permute(1, 0, 2).reshape(d, n * e)
    return y.reshape(b, s, n, cfg.n_kv_heads, cfg.hd).permute(
        2, 0, 3, 1, 4).contiguous()


def cross_kv(params, enc_states, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K/V of the encoder states:
    (L, B, Hkv, S_enc, hd) x2, contiguous (the decode kernel reads each
    layer's slice as a contiguous cache)."""
    cross = params["decoder"]["cross"]
    return (_kv_all_layers(enc_states, cross["wk"], cfg),
            _kv_all_layers(enc_states, cross["wv"], cfg))


def decode_train(params, enc_states, tokens, cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder pass. tokens: (B, S). Returns the final-normed
    hidden states (B, S, D)."""
    s = tokens.shape[1]
    x = params["embed"][tokens] + params["dec_pos"][:s][None]
    positions = torch.arange(s, device=x.device)
    ck, cv = cross_kv(params, enc_states, cfg)

    def body(x, bp, ck, cv):
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        x = x + L.attn_apply(bp["self"], h, cfg, positions, causal=True,
                             use_rope=False)
        h = L.rmsnorm(x, bp["ln_x"], cfg.norm_eps)
        x = x + L.cross_attn_apply(bp["cross"], h, (ck, cv), cfg)
        h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + L.mlp_apply(bp["mlp"], h)

    remat = cfg.remat and torch.is_grad_enabled()
    for bp, k, v in zip(_unstack(params["decoder"], cfg.n_layers),
                        ck.unbind(0), cv.unbind(0)):
        x = _remat(body, x, bp, k, v) if remat else body(x, bp, k, v)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, batch, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """batch: {'frames': (B, enc_seq, D), 'inputs': (B, S), 'labels': (B,
    S), optional 'mask': (B, S)}, tensors on the params' device. Returns
    (loss, {'ce', 'tokens'}) as 0-d float32 tensors."""
    enc = encode(params, batch["frames"], cfg)
    h = decode_train(params, enc, batch["inputs"], cfg)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    tot, cnt = _chunked_ce(params, h, labels, mask, cfg)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"ce": loss, "tokens": cnt}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_states=None,
               params=None, device="cuda") -> Params:
    """Self-attention KV caches of every decoder layer, {'k', 'v'} of (L, B,
    Hkv, max_len, hd) zeros, and the cross K/V: ``cross_kv`` of
    ``enc_states`` (computed here, with no gradient), or zeros of (L, B,
    Hkv, enc_seq, hd) without them (as the reference's server leaves them).
    """
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    one = L.attn_make_cache(cfg, batch, max_len, dtype, dev)
    cache: Params = {"self": tree_map(
        lambda a: a.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * a.dim()),
        one)}
    if enc_states is not None:
        with torch.no_grad():
            cache["cross"] = cross_kv(params, enc_states.to(dev), cfg)
    else:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.hd)
        cache["cross"] = (torch.zeros(shape, dtype=dtype, device=dev),
                          torch.zeros(shape, dtype=dtype, device=dev))
    return cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """tokens: (B,) int; pos: absolute position, a 0-d integer tensor on the
    params' device (a Python int is turned into one here), never read on
    the host: ``dec_pos`` is read at it by ``index_select``, so one CUDA
    graph of the step serves every position. Returns (logits (B, V) f32,
    cache); the self caches are updated in place."""
    x = params["embed"][tokens]
    pos = torch.as_tensor(pos, device=x.device)
    x = x + params["dec_pos"].index_select(0, pos.long().view(1))
    b = x.shape[0]
    ck, cv = cache["cross"]
    for j in range(cfg.n_layers):
        bp = _layer(params["decoder"], j)
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        mx, _ = L.attn_decode(bp["self"], h, _layer(cache["self"], j), pos,
                              cfg, use_rope=False)
        x = x + mx
        h = L.rmsnorm(x, bp["ln_x"], cfg.norm_eps)
        q = (h @ bp["cross"]["wq"]).reshape(b, cfg.n_heads, cfg.hd)
        ca = ops.decode_attention(q, ck[j], cv[j])
        x = x + ca.reshape(b, -1) @ bp["cross"]["wo"]
        h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(bp["mlp"], h)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["embed"].T).float(), cache
