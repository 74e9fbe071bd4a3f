"""Top-k mixture-of-experts with sorted capacity dispatch.

Counterpart of :mod:`repro.models.moe`, with the same parameter tree and
the same semantics: each token's top-k experts by router probability, the
weights renormalised over the k, token copies sorted by expert (stable), a
capacity window of ``cap`` slots per expert and group, copies beyond it
dropped, and a switch-style load-balance auxiliary loss. The expert
products are batched matrix products (cuBLAS on the card), as the
reference leaves them to XLA outside any Pallas kernel.

Two differences of form, none of result:
- ``partitioning.constrain`` is a no-op without a mesh, and the port has no
  mesh yet (ROADMAP.md, queue 1, item 6), so it is left out.
- The combine gathers instead of scatter-adding. Each (token, j) copy finds
  its slot from its place in the sorted order, and a token sums its k
  contributions in the order j = 0..k-1. A float scatter-add on the card
  adds in the order its atomics land, so eager and graphed steps would
  differ in their last bits; the gather gives the same bits on every call.
Nothing here reads a value on the host (the per-expert counts are a
``scatter_add_``, not ``bincount``), so a CUDA graph can capture it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import mlp_apply, mlp_init
from .module import normal_init


def moe_init(gen, cfg: ModelConfig, dtype, device="cpu") -> Dict:
    """Router (D, E) float32; experts gate/up (E, D, H) and down (E, H, D)
    in ``dtype``, with the reference's scales; the shared expert an
    ``mlp_init`` of width ``n_shared_experts * d_expert``."""
    d, e, h = cfg.d_model, cfg.n_experts, cfg.d_expert
    params = {
        "router": normal_init(gen, (d, e), 0.02, torch.float32, device),
        "experts": {
            "gate": normal_init(gen, (e, d, h), d ** -0.5, dtype, device),
            "up": normal_init(gen, (e, d, h), d ** -0.5, dtype, device),
            "down": normal_init(gen, (e, h, d),
                                h ** -0.5 / (2 * cfg.n_layers) ** 0.5, dtype,
                                device),
        },
    }
    if cfg.n_shared_experts:
        params["shared"] = mlp_init(gen, cfg, dtype,
                                    d_ff=cfg.n_shared_experts * cfg.d_expert,
                                    device=device)
    return params


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert and group for ``t`` tokens, from static shapes:
    ceil(t k cf / (E g)), at least 1."""
    g = max(1, cfg.moe_dispatch_groups)
    return int(max(1, -(-t * cfg.top_k * cfg.capacity_factor
                        // (cfg.n_experts * g))))


def _dispatch_group(xf, probs, k: int, e: int, cap: int):
    """Sorted capacity dispatch for one token group.

    xf: (Tg, D); probs: (Tg, E). Returns (xg (E, cap, D), tok (E, cap),
    wgt (E, cap)) as the reference's, ``tok`` local to the group, and for
    the combine (slot (Tg, k): the flat index e * cap + c of each copy's
    slot, w (Tg, k): its weight, 0 where it was dropped)."""
    t = xf.shape[0]
    dev = xf.device
    top_p, top_idx = torch.topk(probs, k, dim=-1)               # (Tg, k)
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_idx.reshape(-1)                                # (Tg*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st_, sw = flat_e[order], flat_t[order], flat_w[order]
    sizes = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, se, torch.ones_like(se))                             # (E,)
    starts = torch.cumsum(sizes, 0) - sizes
    slots = torch.arange(cap, device=dev)
    win = starts[:, None] + slots[None]                         # (E, cap)
    valid = slots[None] < torch.clamp(sizes, max=cap)[:, None]
    win = torch.clamp(win, 0, t * k - 1)
    tok = st_[win]                                              # (E, cap)
    wgt = torch.where(valid, sw[win], torch.zeros((), dtype=sw.dtype,
                                                  device=dev))
    xg = xf[tok] * valid[..., None].to(xf.dtype)                # (E, cap, D)
    # each copy's place in the sorted order, hence its slot in its expert's
    # window; a copy at c >= cap was dropped
    place = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=dev))
    c = place - starts[flat_e]
    kept = c < cap
    slot = flat_e * cap + torch.clamp(c, max=cap - 1)
    w = torch.where(kept, flat_w, torch.zeros((), dtype=flat_w.dtype,
                                              device=dev))
    return xg, tok, wgt, slot.view(t, k), w.view(t, k)


def moe_apply(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss 0-d float32).

    ``cfg.moe_dispatch_groups`` g > 1 routes tokens within g groups, each
    with ``cap`` slots per expert (the reference's grouped local dispatch);
    ``cfg.moe_combine_dtype`` is the dtype the k contributions are summed
    in."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    g = max(1, cfg.moe_dispatch_groups)
    if t % g:
        raise ValueError(f"moe_apply: {t} tokens do not split into {g} groups")
    tg = t // g
    xf = x.reshape(t, d)

    logits = xf.float() @ p["router"]                           # (T, E)
    probs = torch.softmax(logits, dim=-1)

    # switch-style load balance loss
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = (top1[:, None] == torch.arange(e, device=x.device)).float() \
        .mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_weight

    cap = capacity(cfg, t)
    groups = [_dispatch_group(xf[i * tg:(i + 1) * tg],
                              probs[i * tg:(i + 1) * tg], k, e, cap)
              for i in range(g)]
    # (E, G * cap, D): every group's slots of an expert in one batch
    xg = groups[0][0] if g == 1 else torch.cat([grp[0] for grp in groups], dim=1)
    ex = p["experts"]
    h = F.silu(torch.bmm(xg, ex["gate"])) * torch.bmm(xg, ex["up"])
    out = torch.bmm(h, ex["down"])                              # (E, G*cap, D)

    acc_dt = torch.bfloat16 if cfg.moe_combine_dtype == "bfloat16" \
        else torch.float32
    ys = []
    for i, (_, _, _, slot, w) in enumerate(groups):
        # group i's slots of expert e are rows e * cap .. of its block
        out_g = out[:, i * cap:(i + 1) * cap].reshape(e * cap, d)
        contrib = out_g[slot] * w[..., None]                    # (Tg, k, D)
        y = torch.zeros((tg, d), dtype=acc_dt, device=x.device)
        for j in range(k):
            y = y + contrib[:, j].to(acc_dt)
        ys.append(y)
    y = (ys[0] if g == 1 else torch.cat(ys)).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], xf)
    return y.reshape(b, s, d), aux
