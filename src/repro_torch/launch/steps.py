"""Step functions shared by the trainer and the server.

Counterpart of :mod:`repro.launch.steps`. The port runs eagerly: where the
reference jits a step, the port returns a plain function. The train step
differentiates the loss with autograd (through the backward kernels on the
card); the prefill and decode steps run under ``torch.no_grad``. The
prefill runs every ported family (dense, the Jamba hybrid through the CUDA
selective scan, xLSTM); the decode step updates the KV cache and the
recurrent states in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.models import model_api, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_map
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm


def _require_on(params, dev: torch.device) -> None:
    where = params["embed"].device
    if where.type != dev.type or (dev.index is not None and where != dev):
        raise ValueError(f"params live on {where}, the step runs on {dev}")


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    clip_norm: float = 1.0, device="cuda") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient (``backward()``), global-norm
    clipping to ``clip_norm`` and the optimizer's update.

    ``params`` is the reference's tree of plain tensors on ``device``; the
    step marks detached copies as requiring grad and returns new params.
    ``batch`` holds 'inputs' or 'embeds', 'labels' and optionally 'mask', as
    tensors or numpy arrays. ``metrics``: 'loss', 'grad_norm' (before
    clipping), 'ce', 'aux', 'tokens', as 0-d tensors."""
    dev = resolve_device(device)
    api = model_api(cfg)

    def train_step(params, opt_state, batch):
        _require_on(params, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        loss, metrics = api.loss(p, b, cfg)
        loss.backward()
        # a leaf the loss does not reach has a zero gradient, as under jax.grad
        grads = tree_map(lambda a: a.grad if a.grad is not None
                         else torch.zeros_like(a), p)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = optimizer.update(grads, opt_state, params)
        out = {"loss": loss.detach(), "grad_norm": gnorm}
        out.update({k: v.detach() for k, v in metrics.items()})
        return params, opt_state, out

    return train_step


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
