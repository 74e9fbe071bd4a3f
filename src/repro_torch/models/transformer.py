"""Decoder-only LM assembled from periodic blocks.

Counterpart of :mod:`repro.models.transformer`. Parameters keep the
reference's stacked layout (``params["stack"]["pos{i}"]`` with a leading
``n_periods`` axis); where the reference runs ``lax.scan`` over that axis the
port loops over it in Python.

Entry points:
  init(gen, cfg, device)                 -> params
  forward(params, x, cfg, positions)     -> (hidden, aux_loss)
  lm_loss(params, batch, cfg[, total, aux_weight]) -> (loss, metrics)
  init_cache(cfg, batch, max_len, device) -> decode cache
  decode_step(params, cache, tok, pos, cfg) -> (logits, cache)

Ported blocks: an attention, MLA, Mamba, mLSTM or sLSTM mixer with a dense
MLP, an MoE FFN or none; DeepSeek's ``first_k_dense`` prefix runs as a list
of unstacked layers (``params["prefix"]``, ``cache["prefix"]``) before the
stack (a config with no period past the prefix, such as DeepSeek-V3 cut to
its 3 dense layers, has an empty stack). With ``cfg.mtp`` ``init`` builds
the MTP module and ``lm_loss`` adds its next-but-one-token loss, as the
reference's. Encoder-decoder configs belong to ``encdec.py`` and raise
here.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from . import layers as L
from . import moe as M
from . import partitioning as part
from . import ssm as S
from . import tensor_parallel as tp
from .config import ModelConfig
from .module import dense_init, embed_init, stack_init, tree_map

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# recurrent mixer -> (init, apply, make_cache, decode); attention and MLA
# take positions and a cache length besides, and are called by name
_RECURRENT = {
    "mamba": (S.mamba_init, S.mamba_apply, S.mamba_make_cache,
              S.mamba_decode),
    "mlstm": (S.mlstm_init, S.mlstm_apply, S.mlstm_make_cache,
              S.mlstm_decode),
    "slstm": (S.slstm_init, S.slstm_apply, S.slstm_make_cache,
              S.slstm_decode),
}
_MIXERS = ("attn", "mla") + tuple(_RECURRENT)


def _check_spec(spec) -> None:
    mixer, ffn = spec
    if mixer not in _MIXERS or ffn not in ("mlp", "moe", None):
        raise ValueError(f"unknown block {spec}")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder config runs through "
            "models.encdec (model_api), not the decoder-only transformer")
    for spec in cfg.period:
        _check_spec(spec)


def _check_token_split(cfg: ModelConfig) -> None:
    """Under a token split (``partitioning.seq_axis()``) a rank holds its
    shard of each row, and only the ring sees the other shards: the model
    must be a ``seq_shard`` decoder of attention blocks with dense FFNs
    and no MTP module, as the reference's ``seq_shard`` configs are. An
    MLA, Mamba or LSTM mixer, MoE routing and its load-balance loss, or
    MTP's next-shard token would see the shard alone, and raise
    NotImplementedError."""
    if part.seq_axis() is None:
        return
    other = sorted({f"{m}/{f}" for m, f in cfg.blocks()
                    if m != "attn" or f == "moe"})
    if not cfg.seq_shard or other or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: a token split over 'model' runs seq_shard decoders "
            f"of attention and dense FFN blocks (seq_shard {cfg.seq_shard}, "
            f"other blocks {other}, mtp {bool(cfg.mtp)})")


def _prefix_spec(cfg: ModelConfig):
    """The dense prefix's blocks: the period's mixer with a dense MLP."""
    return (cfg.period[0][0], "mlp")


def _layer(stacked: Params, j: int) -> Params:
    """Layer j of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[j], stacked)


def _unstack(stacked: Params, n: int) -> list:
    """The n layers of a stacked tree as views, one ``unbind`` per leaf:
    the backward of ``unbind`` stacks the layers' gradients in one write,
    where a ``_layer`` index per layer would write a zero stack of the leaf
    for each layer and add it in."""
    parts = tree_map(lambda a: a.unbind(0), stacked)
    return [tree_map(lambda _, p, j=j: p[j], stacked, parts) for j in range(n)]


# --------------------------------------------------------------------------
# Block init / apply / decode
# --------------------------------------------------------------------------

def block_init(gen, spec, cfg: ModelConfig, dtype, device="cpu") -> Params:
    _check_spec(spec)
    mixer, ffn = spec
    init_fn = {"attn": L.attn_init, "mla": L.mla_init}.get(mixer) \
        or _RECURRENT[mixer][0]
    bp: Params = {"ln1": L.rmsnorm_init(cfg.d_model, device),
                  "mixer": init_fn(gen, cfg, dtype, device)}
    if ffn is not None:
        bp["ln2"] = L.rmsnorm_init(cfg.d_model, device)
        bp["ffn"] = (M.moe_init(gen, cfg, dtype, device) if ffn == "moe"
                     else L.mlp_init(gen, cfg, dtype, device=device))
    return bp


def block_apply(bp, x, spec, cfg: ModelConfig, positions):
    """Returns (x, aux): the MoE FFN's load-balance loss, a 0-d float32
    tensor; blocks without MoE carry none (aux = 0.0, no kernel)."""
    _check_spec(spec)
    mixer, ffn = spec
    aux = 0.0
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if mixer == "attn":
        x = x + L.attn_apply(bp["mixer"], h, cfg, positions)
    elif mixer == "mla":
        x = x + L.mla_apply(bp["mixer"], h, cfg, positions)
    else:
        x = x + _RECURRENT[mixer][1](bp["mixer"], h, cfg)
    if ffn is not None:
        h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if ffn == "moe":
            y, aux = M.moe_apply(bp["ffn"], h2, cfg)
        else:
            y = L.mlp_apply(bp["ffn"], h2, width=cfg.d_ff)
        x = x + y
    return x, aux


def block_make_cache(spec, cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device="cpu"):
    _check_spec(spec)
    mixer, _ = spec
    if mixer == "attn":
        return L.attn_make_cache(cfg, batch, max_len, dtype, device)
    if mixer == "mla":
        return L.mla_make_cache(cfg, batch, max_len, dtype, device)
    return _RECURRENT[mixer][2](cfg, batch, dtype, device)


def block_decode(bp, x, cache, spec, cfg: ModelConfig, pos: torch.Tensor):
    _check_spec(spec)
    mixer, ffn = spec
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if mixer == "attn":
        mx, cache = L.attn_decode(bp["mixer"], h, cache, pos, cfg)
    elif mixer == "mla":
        mx, cache = L.mla_decode(bp["mixer"], h, cache, pos, cfg)
    else:
        mx, cache = _RECURRENT[mixer][3](bp["mixer"], h, cache, cfg)
    x = x + mx
    if ffn is not None:
        h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if ffn == "moe":
            # one token a sequence routes as a (B, 1) batch; aux is dropped
            y, _ = M.moe_apply(bp["ffn"], h2[:, None, :], cfg)
            y = y[:, 0]
        else:
            y = L.mlp_apply(bp["ffn"], h2, width=cfg.d_ff)
        x = x + y
    return x, cache


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random parameters drawn from ``gen`` (on the generator's device, or
    nowhere for ``device="meta"``) and placed on ``device``."""
    dev = resolve_device(device)
    _check_supported(cfg)
    dtype = _dtype(cfg)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device=dev),
        "final_norm": L.rmsnorm_init(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype,
                                    device=dev)
    if cfg.first_k_dense:
        params["prefix"] = [block_init(gen, _prefix_spec(cfg), cfg, dtype, dev)
                            for _ in range(cfg.first_k_dense)]
    # no period past the prefix: an empty stack, and no layer drawn for it
    params["stack"] = {
        f"pos{i}": stack_init(
            lambda g, spec=spec: block_init(g, spec, cfg, dtype, dev),
            gen, cfg.n_periods)
        for i, spec in enumerate(cfg.period)} if cfg.n_periods else {}
    if cfg.mtp:
        params["mtp"] = {
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype=dtype,
                               device=dev),
            "norm_h": L.rmsnorm_init(cfg.d_model),
            "norm_e": L.rmsnorm_init(cfg.d_model),
            "block": block_init(gen, cfg.period[0], cfg, dtype, dev),
            "final_norm": L.rmsnorm_init(cfg.d_model),
        }
    return tree_map(lambda a: a.to(dev), params)


def forward(params, x, cfg: ModelConfig, positions) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """x: (B, S, D) embedded inputs -> (hidden (B,S,D), aux_loss).

    aux_loss sums the MoE blocks' load-balance losses (0 without MoE; the
    dense prefix has none). With ``cfg.remat`` and grad enabled each
    period runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` with nothing saveable): only its input is kept, and
    its forward runs again in the backward pass; the prefix layers run
    unscanned and uncheckpointed, as in the reference. Each stacked leaf is
    taken apart once (``_unstack``), outside the checkpointed periods, so
    its gradient is written once. Under a token split ``x`` is this rank's
    shard and ``positions`` its absolute positions; a model that the ring
    does not cover raises (``_check_token_split``)."""
    _check_token_split(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in params.get("prefix", []):
        x, _ = block_apply(bp, x, _prefix_spec(cfg), cfg, positions)

    def period_body(x, aux, layers):
        for i, spec in enumerate(cfg.period):
            x, a = block_apply(layers[i], x, spec, cfg, positions)
            if spec[1] == "moe":
                aux = aux + a
        return x, aux

    stacks = [_unstack(params["stack"][f"pos{i}"], cfg.n_periods)
              for i in range(len(cfg.period))] if cfg.n_periods else []
    for j in range(cfg.n_periods):
        layers = [stack[j] for stack in stacks]
        if cfg.remat and torch.is_grad_enabled():
            # no random numbers to replay: the RNG state is not stashed,
            # which also keeps the step capturable in a CUDA graph
            x, aux = checkpoint(period_body, x, aux, layers,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = period_body(x, aux, layers)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def logits_fn(params, h, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (h @ w).float()


def embed_tokens(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """The rows of ``tokens``. Where ``embed`` holds fewer than ``cfg.vocab``
    rows it is this rank's slice over 'model' (vocab-parallel): each rank
    looks up the tokens in its rows, the others give zeros, and the ranks'
    lookups are summed."""
    e = params["embed"]
    if e.shape[0] == cfg.vocab:
        return e[tokens]
    lo, hi = tp.local_range(cfg.vocab)
    inside = (tokens >= lo) & (tokens < hi)
    rows = e[torch.where(inside, tokens - lo, 0)]
    return tp.reduce_from_model(rows.masked_fill(~inside[..., None], 0))


def _chunked_ce(params, h, labels, mask, cfg: ModelConfig,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy summed over chunks of ``chunk`` positions, so the
    float32 logits never hold (B, S, V) at once. Returns (sum of the masked
    token losses, sum of the mask).

    Where the output embedding (``embed`` tied, else ``head``) holds this
    rank's slice of the vocab over 'model', each rank computes the logits
    of its vocab slice only: the log-sum-exp takes the maximum over the
    ranks (no gradient: the log-sum-exp's does not depend on it) and sums
    their exponentials, and the gold logit comes from the rank that holds
    the label (the others add zero); no rank holds a chunk's logits over
    the whole vocab."""
    s = h.shape[1]
    chunk = min(chunk, s)
    w = params["embed"] if cfg.tie_embeddings else params["head"].T
    split = w.shape[0] != cfg.vocab
    if split:
        h = tp.copy_to_model(h)
        lo, hi = tp.local_range(cfg.vocab)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        lg = logits_fn(params, h[:, i:i + chunk], cfg)       # (B, c, V) f32
        lab = labels[:, i:i + chunk].long()
        msk = mask[:, i:i + chunk]
        if split:                                   # lg: (B, c, V / ranks)
            top = tp.max_over_model(lg.amax(dim=-1))
            inside = (lab >= lo) & (lab < hi)
            gold = torch.gather(lg, -1, torch.where(inside, lab - lo, 0)[..., None])
            gold = torch.where(inside, gold[..., 0], 0.0)
            sums, gold = tp.reduce_from_model(torch.stack(
                [torch.exp(lg - top[..., None]).sum(dim=-1), gold])).unbind()
            lse = top + torch.log(sums)
        else:
            lse = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, lab[..., None])[..., 0]
        tot = tot + torch.sum((lse - gold) * msk)
        cnt = cnt + torch.sum(msk)
    return tot, cnt


def lm_loss(params, batch, cfg: ModelConfig, total=None,
            aux_weight: float = 1.0) -> Tuple[torch.Tensor, Dict]:
    """batch: {'inputs': (B,S) int | 'embeds': (B,S,D), 'labels': (B,S),
    optional 'mask': (B,S)}, tensors on the params' device. Returns (loss,
    {'ce', 'aux', 'tokens'}) as 0-d float32 tensors; loss = ce + aux. With
    ``cfg.mtp`` and token inputs the MTP module predicts token t + 2 from
    h_t and the embedding of token t + 1 through one ``cfg.period[0]``
    block, and loss = ce + mtp_weight * mtp + aux, with 'mtp' in the
    metrics (the reference's order of sums).

    Under data parallelism each rank's loss is its part of the global
    batch's: ``total`` maps a token count (a 0-d tensor) to the count over
    every rank, which each mean then divides by ('tokens' is that count),
    and ``aux_weight`` (1 / ranks) weights the aux loss, so the ranks'
    losses, terms and gradients sum to the global ones. Under a token split
    (``partitioning.seq_axis()``) the batch holds this rank's contiguous
    shard of L tokens of each row, at positions ``seq_index() * L`` on, and
    ``total`` counts over the token axis too; a model the ring does not
    cover raises NotImplementedError there (``_check_token_split``)."""
    _check_supported(cfg)
    _check_token_split(cfg)     # before the shard's positions are placed
    if "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = embed_tokens(params, batch["inputs"], cfg)
    length = x.shape[1]
    positions = torch.arange(length, device=x.device) + part.seq_index() * length
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    h, aux = forward(params, x, cfg, positions)
    if aux_weight != 1.0:
        aux = aux * aux_weight
    tot, cnt = _chunked_ce(params, h, labels, mask, cfg)
    if total is not None:
        cnt = total(cnt)
    loss = tot / torch.clamp(cnt, min=1.0)
    metrics = {"ce": loss, "aux": aux, "tokens": cnt}
    if cfg.mtp and "inputs" in batch:
        mp = params["mtp"]
        # the kernels take contiguous rows: h without its last position
        h_in = L.rmsnorm(h[:, :-1].contiguous(), mp["norm_h"], cfg.norm_eps)
        e_in = L.rmsnorm(embed_tokens(params, labels[:, :-1], cfg),
                         mp["norm_e"], cfg.norm_eps)
        x2 = torch.cat([h_in, e_in], dim=-1)
        if mp["proj"].shape[1] != cfg.d_model:
            # this rank's output columns over 'model', gathered whole; the
            # MTP block after it takes its whole gradient on every rank
            x2 = tp.gather_from_model(tp.copy_to_model(x2) @ mp["proj"], -1,
                                      whole_grad=True)
        else:
            x2 = x2 @ mp["proj"]
        x2, _ = block_apply(mp["block"], x2, cfg.period[0], cfg,
                            positions[:-1])
        x2 = L.rmsnorm(x2, mp["final_norm"], cfg.norm_eps)
        # S - 1 positions: the last chunk may be ragged
        tot2, cnt2 = _chunked_ce(params, x2, labels[:, 1:], mask[:, 1:], cfg)
        if total is not None:
            cnt2 = total(cnt2)
        mtp = tot2 / torch.clamp(cnt2, min=1.0)
        loss = loss + cfg.mtp_weight * mtp
        metrics["mtp"] = mtp
    return loss + aux, metrics


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Params:
    """Decoding holds whole rows: under a token split it raises
    NotImplementedError."""
    dev = resolve_device(device)
    _check_supported(cfg)
    if part.seq_axis() is not None:
        raise NotImplementedError(
            f"{cfg.name}: decoding under a token split over 'model'")
    dtype = _dtype(cfg)
    cache: Params = {}
    if cfg.first_k_dense:
        cache["prefix"] = [block_make_cache(_prefix_spec(cfg), cfg, batch,
                                            max_len, dtype, device=dev)
                           for _ in range(cfg.first_k_dense)]
    stack = {}
    for i, spec in enumerate(cfg.period if cfg.n_periods else ()):
        # one layer's cache (zeros, or -1e30 for the mLSTM stabiliser),
        # repeated over the stacked axis
        one = block_make_cache(spec, cfg, batch, max_len, dtype, device=dev)
        stack[f"pos{i}"] = tree_map(
            lambda a: a.unsqueeze(0).repeat((cfg.n_periods,) + (1,) * a.dim()),
            one)
    cache["stack"] = stack
    return cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """tokens: (B,) int; pos: absolute position, a 0-d integer tensor on the
    params' device (a Python int is turned into one here). Returns (logits
    (B, V) f32, cache); the cache is updated in place. Under tensor
    parallelism the lookup is vocab-parallel (:func:`embed_tokens`) and the
    logits of this rank's vocab slice are gathered whole over 'model'; the
    mixers read their layouts from their leaves and caches
    (``layers.attn_decode``; the others refuse a 'model' axis above 1)."""
    x = embed_tokens(params, tokens, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    for bp, bc in zip(params.get("prefix", []), cache.get("prefix", [])):
        x, _ = block_decode(bp, x, bc, _prefix_spec(cfg), cfg, pos)
    for j in range(cfg.n_periods):
        for i, spec in enumerate(cfg.period):
            key = f"pos{i}"
            x, _ = block_decode(_layer(params["stack"][key], j), x,
                                _layer(cache["stack"][key], j), spec, cfg, pos)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return whole_vocab(logits_fn(params, x, cfg), cfg), cache


def whole_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``logits`` (..., V) of this rank's vocab slice over 'model' gathered
    whole (in rank order); whole logits as they are."""
    if logits.shape[-1] == cfg.vocab:
        return logits
    return tp.gather_from_model(logits, -1)
