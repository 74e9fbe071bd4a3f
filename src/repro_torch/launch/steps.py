"""Step functions shared by the trainer and the server.

Counterpart of :mod:`repro.launch.steps`. Where the reference jits a step,
the port captures it in a CUDA graph on the card (:mod:`.graphs`): each
``make_*_step`` returns, for a CUDA device, a :class:`~.graphs.GraphedStep`
that captures at its first call for a given binding and then replays. On
the CPU, or with ``graphs=False`` (to compare the two on the card), it
returns the eager function; nothing switches between the two on its own.
The train step differentiates the loss with autograd (through the backward
kernels on the card) and updates params and optimizer state in place; the
prefill and decode steps run under ``torch.no_grad``. The prefill runs
every ported family (dense, the Jamba hybrid through the CUDA selective
scan, xLSTM, MoE with MLA or GQA attention, a vlm backbone on fused
``embeds``, the Whisper-style encoder-decoder on audio frames); the decode
step updates the KV caches, MLA's compressed caches and the recurrent
states in place (DeepSeek's dense prefix as a list beside the stack; the
encoder-decoder's self caches beside its fixed cross K/V) and takes its
position as a device tensor, so one graph serves every step.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.kernels.adamw import global_norm_scale
from repro_torch.launch.graphs import GraphedStep
from repro_torch.models import encdec, model_api, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import Optimizer


def _require_on(params, dev: torch.device) -> None:
    where = params["embed"].device
    if where.type != dev.type or (dev.index is not None and where != dev):
        raise ValueError(f"params live on {where}, the step runs on {dev}")


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    clip_norm: float = 1.0, device="cuda",
                    graphs: bool = True) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient (``backward()``), global-norm
    clipping to ``clip_norm`` and the optimizer's update, each phase in a
    ``record_function`` range (``loss_fwd``, ``backward``, ``clip``,
    ``optimizer``) for the profiler. The clip computes the norm and its
    scale once (``kernels.adamw.global_norm_scale``: the ``sumsq`` and
    ``clip_finalize`` kernels on the card) and the optimizer applies the
    scale leaf by leaf (``grad_scale``; AdamW in the fused kernel), as the
    reference's clip followed by its update.

    ``params`` is the reference's tree of plain tensors on ``device``; the
    step marks detached views as requiring grad and the optimizer writes
    params and state in place (the reference donates both), returning the
    same trees. ``batch`` holds 'inputs' or 'embeds', 'labels' and
    optionally 'mask' ('frames' besides for an encoder-decoder), as tensors
    or numpy arrays. ``metrics``: 'loss',
    'grad_norm' (before clipping) and the loss's metrics ('ce', 'aux',
    'tokens'; an encoder-decoder has no 'aux'), as 0-d tensors.

    On a CUDA device (unless ``graphs=False``) the step is captured in a
    CUDA graph at its first call for a given (params, opt_state) and batch
    shapes: forward, backward (remat included), clip and update replay as
    one graph; the batch is copied into the graph's buffers and the metrics
    are the graph's outputs, overwritten by the next step."""
    dev = resolve_device(device)
    api = model_api(cfg)

    def train_step(params, opt_state, batch):
        _require_on(params, dev)
        with record_function("loss_fwd"):
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            p = tree_map(lambda a: a.detach().requires_grad_(True), params)
            loss, metrics = api.loss(p, b, cfg)
        with record_function("backward"):
            loss.backward()
            # a leaf the loss does not reach has a zero gradient, as under
            # jax.grad
            grads = tree_map(lambda a: a.grad if a.grad is not None
                             else torch.zeros_like(a), p)
        with record_function("clip"):
            gnorm, scale = global_norm_scale(tree_leaves(grads), clip_norm)
        with record_function("optimizer"):
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 grad_scale=scale)
        out = {"loss": loss.detach(), "grad_norm": gnorm}
        out.update({k: v.detach() for k, v in metrics.items()})
        return params, opt_state, out

    if dev.type != "cuda" or not graphs:
        return train_step
    return GraphedStep(train_step, 2, dev, mutates=(0, 1), name="train")


def make_prefill_step(cfg: ModelConfig, device="cuda",
                      graphs: bool = True) -> Callable:
    """Inference prefill: full no-grad forward, last-token logits.

    The returned ``prefill_step(params, batch)`` takes ``batch["inputs"]``
    (B, S) token ids or ``batch["embeds"]`` (B, S, D) (an encoder-decoder:
    ``batch["frames"]`` (B, enc_seq, D) and ``batch["inputs"]``; it encodes
    the frames and runs the decoder over the tokens), as tensors or numpy
    arrays, and returns (B, vocab) float32 logits of the last position on
    ``device``. On a CUDA
    device (unless ``graphs=False``) each (B, S) is captured once and
    replayed; the logits returned are the graph's output, which the next
    call of the same shape overwrites."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        _require_on(params, dev)
        if cfg.is_encdec:
            enc = encdec.encode(
                params, torch.as_tensor(batch["frames"], device=dev), cfg)
            h = encdec.decode_train(
                params, enc, torch.as_tensor(batch["inputs"], device=dev), cfg)
            return (h[:, -1] @ params["embed"].T).float()
        if "embeds" in batch:
            x = torch.as_tensor(batch["embeds"], device=dev).to(
                transformer._dtype(cfg))
        else:
            x = transformer.embed_tokens(
                params, torch.as_tensor(batch["inputs"], device=dev), cfg)
        positions = torch.arange(x.shape[1], device=dev)
        h, _ = transformer.forward(params, x, cfg, positions)
        return transformer.logits_fn(params, h[:, -1:], cfg)[:, 0]

    if dev.type != "cuda" or not graphs:
        return prefill_step
    return GraphedStep(prefill_step, 1, dev, name="prefill")


def make_decode_step(cfg: ModelConfig, device="cuda",
                     graphs: bool = True) -> Callable:
    """``serve_step(params, cache, tokens, pos) -> (next (B,) int32, logits,
    cache)``; the cache is updated in place. ``pos`` is the absolute
    position, a Python int or a 0-d integer tensor on the device.

    On a CUDA device (unless ``graphs=False``) the step is captured once per
    (params, cache) and batch size: ``tokens`` and ``pos`` are copied into
    the graph's buffers before each replay (the reference's jitted step
    takes them as traced arguments), the cache is written in place (the
    reference donates it), and ``next`` and ``logits`` are the graph's
    outputs, overwritten by the next step."""
    dev = resolve_device(device)
    api = model_api(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        _require_on(params, dev)
        logits, cache = api.decode_step(
            params, cache, torch.as_tensor(tokens, device=dev), pos, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    if dev.type != "cuda" or not graphs:
        return serve_step
    return GraphedStep(serve_step, 2, dev, mutates=(1,), name="decode")
