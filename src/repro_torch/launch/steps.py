"""Step functions shared by the server (prefill and decode).

Counterpart of :mod:`repro.launch.steps`. The port runs eagerly: where the
reference jits a step, the port returns a plain function that runs under
``torch.no_grad``. The prefill runs every ported family (dense, the Jamba
hybrid through the CUDA selective scan, xLSTM); the decode step updates
the KV cache and the recurrent states in place. ``make_train_step`` comes
with the training slice (ROADMAP.md, queue 1, item 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.models import model_api, transformer
from repro_torch.models.config import ModelConfig


def _require_on(params, dev: torch.device) -> None:
    where = params["embed"].device
    if where.type != dev.type or (dev.index is not None and where != dev):
        raise ValueError(f"params live on {where}, the step runs on {dev}")


def make_prefill_step(cfg: ModelConfig, device="cuda") -> Callable:
    """Inference prefill: full no-grad forward, last-token logits.

    The returned ``prefill_step(params, batch)`` takes ``batch["inputs"]``
    (B, S) token ids or ``batch["embeds"]`` (B, S, D), as tensors or numpy
    arrays, and returns (B, vocab) float32 logits on ``device``."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        raise NotImplementedError(
            "encoder-decoder prefill comes with ROADMAP.md queue 1, item 4")

    @torch.no_grad()
    def prefill_step(params, batch):
        _require_on(params, dev)
        if "embeds" in batch:
            x = torch.as_tensor(batch["embeds"], device=dev).to(
                transformer._dtype(cfg))
        else:
            x = transformer.embed_tokens(
                params, torch.as_tensor(batch["inputs"], device=dev), cfg)
        positions = torch.arange(x.shape[1], device=dev)
        h, _ = transformer.forward(params, x, cfg, positions)
        return transformer.logits_fn(params, h[:, -1:], cfg)[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda") -> Callable:
    """``serve_step(params, cache, tokens, pos) -> (next (B,) int32, logits,
    cache)``; the cache is updated in place."""
    dev = resolve_device(device)
    api = model_api(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos: int):
        _require_on(params, dev)
        logits, cache = api.decode_step(
            params, cache, torch.as_tensor(tokens, device=dev), pos, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return serve_step
