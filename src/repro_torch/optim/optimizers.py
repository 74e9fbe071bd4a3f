"""Optimizers: AdamW and Adafactor, with global-norm clipping and a
warmup + cosine schedule.

Counterpart of :mod:`repro.optim.optimizers`, on nested dicts of tensors,
with the reference's arithmetic and quirks kept as they are:

* weight decay applies to every leaf with ``ndim >= 2``, which includes the
  stacked ``(n_periods, d)`` norm scales;
* params are updated in their storage dtype: a bf16 param goes through
  float32 math and back to bf16, with no float32 master copy;
* moments and factored statistics are float32;
* ``step`` is an int counter (the reference's int32 scalar).

``update`` returns new tensors and leaves its inputs as they were, as the
reference's pure functions do. Learning-rate schedules take the int step
and return a Python float.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.module import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]   # (grads, state, params) -> (p, s)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * min(1.0, (step + 1) / max(warmup, 1))
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
    return lr


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        c1 = 1 - b1 ** step
        c2 = 1 - b2 ** step
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"],
                      grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float() * g.float(),
                      state["nu"], grads)

        def new_param(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if p.dim() >= 2:                      # no decay on norms/bias
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype)

        return (tree_map(new_param, params, mu, nu),
                {"mu": mu, "nu": nu, "step": step})

    return Optimizer(init, update)


def adafactor(lr: Callable | float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def stats(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"stats": tree_map(stats, params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        beta = 1.0 - (step + 1.0) ** -decay

        def new_stats(p, g, st):        # st: the dict of p's statistics
            g2 = g.float() * g.float() + eps
            if p.dim() >= 2:
                return {"vr": beta * st["vr"] + (1 - beta) * g2.mean(dim=-1),
                        "vc": beta * st["vc"] + (1 - beta) * g2.mean(dim=-2)}
            return {"v": beta * st["v"] + (1 - beta) * g2}

        def new_param(p, g, st):
            g = g.float()
            if p.dim() >= 2:
                vr, vc = st["vr"], st["vc"]
                # Shazeer-Stern factored estimate: V ~= vr vc^T / mean(vr)
                mean_vr = torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps)
                vhat = vr[..., :, None] * vc[..., None, :] / mean_vr
                u = g / torch.sqrt(torch.clamp(vhat, min=eps))
            else:
                u = g / torch.sqrt(torch.clamp(st["v"], min=eps))
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.float()
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * p32
            return (p32 - lr_t * u).to(p.dtype)

        stats = tree_map(new_stats, params, grads, state["stats"])
        return (tree_map(new_param, params, grads, stats),
                {"stats": stats, "step": step})

    return Optimizer(init, update)


def pick_optimizer(n_params: int, lr) -> Tuple[str, Optimizer]:
    """Memory policy: Adafactor above 20B params (moments would not fit),
    AdamW otherwise."""
    if n_params > 20e9:
        return "adafactor", adafactor(lr)
    return "adamw", adamw(lr)
