"""Optimizers: AdamW and Adafactor, with global-norm clipping and a
warmup + cosine schedule.

Counterpart of :mod:`repro.optim.optimizers`, on nested dicts of tensors,
with the reference's arithmetic and quirks kept as they are:

* weight decay applies to every leaf with ``ndim >= 2``, which includes the
  stacked ``(n_periods, d)`` norm scales;
* params are updated in their storage dtype: a bf16 param goes through
  float32 math and back to bf16, with no float32 master copy;
* moments and factored statistics are float32;
* ``step`` is a 0-d int32 tensor on the params' device, as the reference's
  ``jnp.zeros((), jnp.int32)``.

``update`` writes params, moments, statistics and ``step`` in place and
returns the same trees, where the reference's pure functions return new
ones (its jitted train step donates them): a CUDA graph of the train step
replays on fixed addresses. Learning-rate schedules take the step tensor
and return a float32 tensor on its device, computed as the reference
computes it, so nothing is read on the host.

AdamW updates each leaf through :func:`repro_torch.kernels.adamw.adamw_update`:
the fused kernel ``csrc/adamw.cu`` on the card, its plain version (this
arithmetic) on the CPU. Both optimizers' ``update`` take ``grad_scale``,
the global-norm clip's scale as a 0-d tensor, and apply it to each gradient
with the clip's storage round trip: ``update(g, s, p, grad_scale=scale)``
equals ``update(clip_by_global_norm(g, max_norm)[0], s, p)`` without the
clipped copy of the gradients.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels.adamw import adamw_update
from repro_torch.models.module import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, grad_scale=None) -> (params, state)
    update: Callable[..., Tuple[Any, Any]]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[Any], torch.Tensor]:
    def lr(step) -> torch.Tensor:
        """``step``: an int or an integer tensor -> float32 tensor (on the
        step tensor's device)."""
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def _step_zero(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else "cpu")


def _advance(state) -> torch.Tensor:
    """``state["step"] += 1`` in place; the new step."""
    step = state["step"]
    if not isinstance(step, torch.Tensor):
        raise TypeError(f"optimizer step must be a 0-d int32 tensor (as "
                        f"init makes it), got {type(step).__name__}")
    return step.add_(1)


def _device_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a Python number or a tensor) as a 0-d float32 tensor on
    ``like``'s device; a number is written by a fill kernel, which a CUDA
    graph captures."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": _step_zero(params)}

    @torch.no_grad()
    def update(grads, state, params, grad_scale=None):
        """``grad_scale``: the clip's scale (a 0-d float32 tensor), applied
        to each gradient with the clip's storage round trip, as
        :func:`clip_by_global_norm` then this update would; None for
        gradients taken as they are."""
        step = _advance(state)
        lr_t = _device_scalar(lr_fn(step), step)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()
        # weight decay on leaves of ndim >= 2 only, as the reference's upd
        tree_map(lambda p, g, m, v: adamw_update(
            p, g, m, v, lr_t, c1, c2, grad_scale, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay), params, grads, state["mu"], state["nu"])
        return params, state

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
        return {"stats": tree_map(stats, params), "step": _step_zero(params)}

    @torch.no_grad()
    def update(grads, state, params, grad_scale=None):
        """``grad_scale`` as :func:`adamw`'s (plain PyTorch here)."""
        step = _advance(state)
        lr_t = lr_fn(step)
        beta = 1.0 - (step.float() + 1.0) ** -decay

        def one(p, g, st):              # st: the dict of p's statistics
            if grad_scale is not None:
                g = (g.float() * grad_scale).to(g.dtype)
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                vr, vc = st["vr"], st["vc"]
                vr.copy_(beta * vr + (1 - beta) * g2.mean(dim=-1))
                vc.copy_(beta * vc + (1 - beta) * g2.mean(dim=-2))
                # Shazeer-Stern factored estimate: V ~= vr vc^T / mean(vr)
                mean_vr = torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps)
                vhat = vr[..., :, None] * vc[..., None, :] / mean_vr
                u = g / torch.sqrt(torch.clamp(vhat, min=eps))
            else:
                v = st["v"]
                v.copy_(beta * v + (1 - beta) * g2)
                u = g / torch.sqrt(torch.clamp(v, min=eps))
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.float()
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * p32
            p.copy_((p32 - lr_t * u).to(p.dtype))

        tree_map(one, params, grads, state["stats"])
        return params, state

    return Optimizer(init, update)


def pick_optimizer(n_params: int, lr) -> Tuple[str, Optimizer]:
    """Memory policy: Adafactor above 20B params (moments would not fit),
    AdamW otherwise."""
    if n_params > 20e9:
        return "adafactor", adafactor(lr)
    return "adamw", adamw(lr)
