"""State-space and recurrent mixers: Mamba (Jamba) and xLSTM (sLSTM + mLSTM).

Counterpart of :mod:`repro.models.ssm`, with the same parameter keys,
dtypes and ``x @ W`` layouts. The Mamba prefill scan goes through
``ops.mamba_scan`` (the CUDA kernel on the card, the plain version on the
CPU); where the reference loops with ``lax.scan`` (sLSTM) the port loops in
Python. Decode paths are single-step state updates, and unlike the
reference, which returns a new cache, they write the new states into the
given cache tensors in place (``copy_``): the model's ``decode_step`` hands
each layer views into the stacked cache and keeps no returned copy.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .config import ModelConfig
from .layers import rmsnorm, rmsnorm_init
from .module import dense_init, normal_init


def _update(cache: Dict, new: Dict) -> Dict:
    """Write ``new`` into the cache tensors in place; returns ``cache``."""
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


# --------------------------------------------------------------------------
# Causal depthwise conv (shared by mamba / mLSTM)
# --------------------------------------------------------------------------

def _causal_conv(x, w, state=None):
    """x: (B, S, C); w: (C, K) depthwise. state: (B, K-1, C) history or None.
    Returns (y (B,S,C), new_state)."""
    b, s, c = x.shape
    k = w.shape[1]
    hist = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device) \
        if state is None else state
    xp = torch.cat([hist.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + s] * w[:, i] for i in range(k))      # K shifted views
    new = xp[:, -(k - 1):] if k > 1 else xp[:, :0]
    return y, new


def _conv_step(x, w, state):
    """x: (B, C); state: (B, K-1, C). Returns (y (B,C), new_state)."""
    xp = torch.cat([state.to(x.dtype), x[:, None]], dim=1)    # (B, K, C)
    y = torch.einsum("bkc,ck->bc", xp, w)
    return y, xp[:, 1:]


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

def mamba_init(gen, cfg: ModelConfig, dtype, device="cpu") -> Dict:
    """A_log, D and dt_bias are float32 in every model dtype, as in the
    reference (a bf16 A would be rounded)."""
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype=dtype, device=device),
        "conv": normal_init(gen, (di, cfg.ssm_conv), cfg.ssm_conv ** -0.5,
                            dtype=dtype, device=device),
        "x_proj": dense_init(gen, di, r + 2 * n, dtype=dtype, device=device),
        "dt_proj": dense_init(gen, r, di, scale=r ** -0.5, dtype=dtype,
                              device=device),
        "dt_bias": torch.zeros((di,), dtype=f32, device=device),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=f32,
                                        device=device).repeat(di, 1)),
        "D": torch.ones((di,), dtype=f32, device=device),
        "out_proj": dense_init(gen, di, d,
                               scale=di ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                               dtype=dtype, device=device),
    }


def _mamba_core(p, xc, z, cfg, h0=None):
    """xc: (B,S,di) post-conv activations; z: gate. Returns (y, h_last)."""
    r, n = cfg.dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"]                                     # (B,S,r+2n)
    dt_r, Bm, Cm = torch.split(proj, [r, n, n], dim=-1)
    # bf16 @ bf16 + f32 bias promotes: dt is float32, as in the reference
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_last = ops.mamba_scan(xc, dt, A, Bm, Cm, p["D"], h0=h0)
    return y * F.silu(z), h_last


def mamba_apply(p, x, cfg: ModelConfig) -> torch.Tensor:
    xz = x @ p["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    xc, _ = _causal_conv(xin, p["conv"])
    xc = F.silu(xc)
    y, _ = _mamba_core(p, xc, z, cfg)
    return y @ p["out_proj"]


def mamba_make_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((batch, k - 1, di), dtype=dtype, device=device),
            "h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device)}


def mamba_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, D). Returns (out (B, D), cache), the cache updated in place."""
    xz = x @ p["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    xc, conv_state = _conv_step(xin, p["conv"], cache["conv"])
    xc = F.silu(xc)
    r, n = cfg.dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"]
    dt_r, Bm, Cm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h = ops.mamba_step(xc, dt, A, Bm, Cm, p["D"], cache["h"])
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, _update(cache, {"conv": conv_state, "h": h})


# --------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM with exponential gating), chunkwise-parallel
# --------------------------------------------------------------------------

def mlstm_init(gen, cfg: ModelConfig, dtype, device="cpu") -> Dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype=dtype, device=device),
        "conv": normal_init(gen, (di, cfg.ssm_conv), cfg.ssm_conv ** -0.5,
                            dtype=dtype, device=device),
        "wq": dense_init(gen, di, di, dtype=dtype, device=device),
        "wk": dense_init(gen, di, di, dtype=dtype, device=device),
        "wv": dense_init(gen, di, di, dtype=dtype, device=device),
        "w_gates": dense_init(gen, d, 2 * h, scale=0.02, dtype=f32,
                              device=device),
        "gate_bias": torch.cat([                  # forget bias high
            torch.linspace(3.0, 6.0, h, dtype=f32, device=device),
            torch.zeros(h, dtype=f32, device=device)]),
        "norm": rmsnorm_init(cfg.d_inner, device),
        "out_proj": dense_init(gen, di, d,
                               scale=di ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                               dtype=dtype, device=device),
    }


def _mlstm_chunk(q, k, v, logf, logi, state):
    """One chunk of the stabilised mLSTM recurrence.

    q/k/v: (B, H, W, dh); logf/logi: (B, H, W); state = (C (B,H,dh,dh),
    n (B,H,dh), m (B,H)).  Returns (h (B,H,W,dh), new_state).
    """
    w, dh = q.shape[2], q.shape[3]
    C0, n0, m0 = state
    Fc = torch.cumsum(logf, dim=-1)                             # (B,H,W)
    # log-weights of key j for query i (j <= i):  F_i - F_j + logi_j
    lw = Fc[..., :, None] - Fc[..., None, :] + logi[..., None, :]
    mask = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    lw = lw.masked_fill(~mask, float("-inf"))
    inter_lw = m0[..., None] + Fc                               # (B,H,W)
    m = torch.maximum(lw.amax(dim=-1), inter_lw)                # (B,H,W)
    m = m.clamp_min(-1e30)
    dec = torch.exp(lw - m[..., None])                          # (B,H,W,W)
    inter = torch.exp(inter_lw - m)                             # (B,H,W)
    scale = dh ** -0.5
    scores = torch.einsum("bhwd,bhud->bhwu", q, k) * scale * dec
    h_intra = torch.einsum("bhwu,bhud->bhwd", scores, v)
    h_inter = inter[..., None] * torch.einsum("bhij,bhwj->bhwi", C0, q) * scale
    n_i = torch.einsum("bhwu,bhud->bhwd", dec, k) \
        + inter[..., None] * n0[..., None, :]
    denom = torch.maximum(
        torch.abs(torch.einsum("bhwd,bhwd->bhw", n_i, q) * scale),
        torch.exp(-m))
    h = (h_intra + h_inter) / denom[..., None]
    # chunk-end state
    Fw = Fc[..., -1]                                            # (B,H)
    lw_end = Fw[..., None] - Fc + logi                          # (B,H,W)
    m_end = torch.maximum(m0 + Fw, lw_end.amax(dim=-1))
    wgt = torch.exp(lw_end - m_end[..., None])
    carry = torch.exp(m0 + Fw - m_end)
    C1 = carry[..., None, None] * C0 + torch.einsum(
        "bhw,bhwd,bhwe->bhde", wgt, v, k)
    n1 = carry[..., None] * n0 + torch.einsum("bhw,bhwd->bhd", wgt, k)
    return h, (C1, n1, m_end)


def mlstm_apply(p, x, cfg: ModelConfig) -> torch.Tensor:
    b, s, d = x.shape
    hh = cfg.n_heads
    di = cfg.d_inner
    dh = di // hh
    xz = x @ p["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    xc, _ = _causal_conv(xin, p["conv"])
    xc = F.silu(xc)
    q = (xc @ p["wq"]).reshape(b, s, hh, dh).transpose(1, 2)
    k = (xc @ p["wk"]).reshape(b, s, hh, dh).transpose(1, 2)
    v = (xin @ p["wv"]).reshape(b, s, hh, dh).transpose(1, 2)
    gates = x.float() @ p["w_gates"] + p["gate_bias"]
    logf = F.logsigmoid(gates[..., :hh]).transpose(1, 2)
    logi = gates[..., hh:].transpose(1, 2)                     # (B,H,S)
    # the reference's adaptive chunk: at most 32 chunks
    w = min(max(cfg.lstm_chunk, s // 32), s)
    if s % w:
        raise ValueError(f"mlstm: sequence length {s} is not a multiple of "
                         f"the chunk {w}")
    state = (torch.zeros((b, hh, dh, dh), dtype=torch.float32, device=x.device),
             torch.zeros((b, hh, dh), dtype=torch.float32, device=x.device),
             torch.full((b, hh), -1e30, dtype=torch.float32, device=x.device))
    hs = []
    for c0 in range(0, s, w):
        hc, state = _mlstm_chunk(
            q[:, :, c0:c0 + w].float(), k[:, :, c0:c0 + w].float(),
            v[:, :, c0:c0 + w].float(), logf[:, :, c0:c0 + w],
            logi[:, :, c0:c0 + w], state)
        hs.append(hc)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, di)
    h = rmsnorm(h.to(x.dtype), p["norm"], cfg.norm_eps)
    return (h * F.silu(z)) @ p["out_proj"]


def mlstm_make_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    hh = cfg.n_heads
    dh = cfg.d_inner // hh
    f32 = torch.float32
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "C": torch.zeros((batch, hh, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, hh, dh), dtype=f32, device=device),
            "m": torch.full((batch, hh), -1e30, dtype=f32, device=device)}


def mlstm_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, D). Returns (out (B, D), cache), the cache updated in place."""
    b, d = x.shape
    hh = cfg.n_heads
    di = cfg.d_inner
    dh = di // hh
    xz = x @ p["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    xc, conv_state = _conv_step(xin, p["conv"], cache["conv"])
    xc = F.silu(xc)
    q = (xc @ p["wq"]).reshape(b, hh, dh).float()
    k = (xc @ p["wk"]).reshape(b, hh, dh).float()
    v = (xin @ p["wv"]).reshape(b, hh, dh).float()
    gates = x.float() @ p["w_gates"] + p["gate_bias"]
    logf = F.logsigmoid(gates[..., :hh])
    logi = gates[..., hh:]
    m = torch.maximum(logf + cache["m"], logi)
    fc = torch.exp(logf + cache["m"] - m)
    ic = torch.exp(logi - m)
    scale = dh ** -0.5
    C = fc[..., None, None] * cache["C"] + ic[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k)
    n = fc[..., None] * cache["n"] + ic[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", C, q) * scale
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q) * scale),
                        torch.exp(-m))
    h = (num / den[..., None]).reshape(b, di)
    h = rmsnorm(h.to(x.dtype), p["norm"], cfg.norm_eps)
    out = (h * F.silu(z)) @ p["out_proj"]
    return out, _update(cache, {"conv": conv_state, "C": C, "n": n, "m": m})


# --------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with exponential gating + recurrent weights)
# --------------------------------------------------------------------------

def slstm_init(gen, cfg: ModelConfig, dtype, device="cpu") -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    f32 = torch.float32
    return {
        "w": dense_init(gen, d, 4 * d, dtype=dtype, device=device),  # i,f,z,o
        "r": normal_init(gen, (4, h, dh, dh), dh ** -0.5, dtype=dtype,
                         device=device),
        "b": torch.cat([torch.zeros(d, dtype=f32, device=device),
                        torch.full((d,), 3.0, dtype=f32, device=device),
                        torch.zeros(2 * d, dtype=f32, device=device)]),
        "out_proj": dense_init(gen, d, d,
                               scale=d ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                               dtype=dtype, device=device),
    }


def _slstm_cell(p, wx_t, state, cfg: ModelConfig):
    """wx_t: (B, 4D) precomputed input contribution; state=(h,c,n,m)."""
    h_prev, c_prev, n_prev, m_prev = state
    b, d = h_prev.shape
    hh = cfg.n_heads
    dh = d // hh
    hp = h_prev.reshape(b, hh, dh)
    rec = torch.einsum("bhd,ghde->bghe", hp.float(),
                       p["r"].float()).reshape(b, 4 * d)
    g = wx_t.float() + rec + p["b"]
    gi, gf, gz, go = g.chunk(4, dim=-1)
    m = torch.maximum(F.logsigmoid(gf) + m_prev, gi)
    i = torch.exp(gi - m)
    f = torch.exp(F.logsigmoid(gf) + m_prev - m)
    c = f * c_prev + i * torch.tanh(gz)
    n = f * n_prev + i
    h = torch.sigmoid(go) * c / n.clamp_min(1e-6)
    return h, (h, c, n, m)


def slstm_apply(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Sequential loop over time (non-associative recurrence)."""
    b, s, d = x.shape
    wx = x @ p["w"]                                            # (B,S,4D)
    state = tuple(torch.zeros((b, d), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(s):
        h, state = _slstm_cell(p, wx[:, t], state, cfg)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    return h @ p["out_proj"]


def slstm_make_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    d = cfg.d_model
    return {key: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for key in ("h", "c", "n", "m")}


def slstm_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, D). Returns (out (B, D), cache), the cache updated in place."""
    wx = x @ p["w"]
    h, (h2, c, n, m) = _slstm_cell(
        p, wx, (cache["h"], cache["c"], cache["n"], cache["m"]), cfg)
    out = h.to(x.dtype) @ p["out_proj"]
    return out, _update(cache, {"h": h2, "c": c, "n": n, "m": m})
