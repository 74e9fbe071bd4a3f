"""State-space and recurrent mixers: Mamba (Jamba) and xLSTM (sLSTM + mLSTM).

Counterpart of :mod:`repro.models.ssm`, with the same parameter keys,
dtypes and ``x @ W`` layouts. The Mamba prefill scan goes through
``ops.mamba_scan`` (the CUDA kernel on the card, the plain version on the
CPU); where the reference loops with ``lax.scan`` (sLSTM) the port loops in
Python. Decode paths are single-step state updates, and unlike the
reference, which returns a new cache, they write the new states into the
given cache tensors in place (``copy_``): the model's ``decode_step`` hands
each layer views into the stacked cache and keeps no returned copy. Under
tensor parallelism (:mod:`.tensor_parallel`) ``mamba_apply`` runs this
rank's channels of d_inner, ``mlstm_apply`` and ``slstm_apply`` their
projections' slices around a recurrence that runs whole on every rank.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import ops
from . import tensor_parallel as tp
from .config import ModelConfig
from .layers import rmsnorm, rmsnorm_init
from .module import dense_init, normal_init

# The dry-run's cut of the sLSTM time loop (``launch.dryrun.CutLoop``), set
# while it measures a cell at two short loops and extrapolates to the whole
# sequence: ``begin(wx, s)`` -> (the steps to run, wx), ``after_step()``
# after each, ``stack(hs, s)`` -> the (B, s, D) output of the steps run,
# ``end()``. Only fake tensors read it: real tensors run every step
# whatever it holds.
CUT_LOOP = None


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
    """xc: (B,S,di) post-conv activations; z: gate. Returns (y, h_last).
    Under tensor parallelism (``x_proj`` holds this rank's rows of d_inner,
    :func:`mamba_apply`) xc and z are this rank's channels: the ranks'
    partial (dt_r, B, C) are summed, and each rank takes its channels of
    ``dt_bias``."""
    r, n = cfg.dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"]                                     # (B,S,r+2n)
    dt_bias = p["dt_bias"]
    if p["x_proj"].shape[0] != cfg.d_inner:
        # the sum feeds this rank's channels again: its gradient is summed
        proj = tp.copy_to_model(tp.reduce_from_model(proj))
        dt_bias = tp.copy_to_model(dt_bias)[slice(*tp.local_range(
            cfg.d_inner))]
    dt_r, Bm, Cm = torch.split(proj, [r, n, n], dim=-1)
    # bf16 @ bf16 + f32 bias promotes: dt is float32, as in the reference
    dt = F.softplus(dt_r @ p["dt_proj"] + dt_bias)
    A = -torch.exp(p["A_log"])
    y, h_last = ops.mamba_scan(xc, dt, A, Bm, Cm, p["D"], h0=h0)
    return y * F.silu(z), h_last


def mamba_apply(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Prefill Mamba, x: (B, S, D) -> (B, S, D).

    Tensor parallelism (:mod:`.tensor_parallel`) is read from the leaves:
    where ``in_proj`` holds fewer than its 2 d_inner columns, ``conv``,
    ``x_proj``, ``A_log``, ``D`` (rows), ``dt_proj`` (columns) and
    ``out_proj`` (rows) hold this rank's channels [lo, hi) of d_inner
    (``tp.local_range``; the rules split them all where 'model' divides
    d_inner). ``in_proj``'s columns are [x | z] and the rules split them
    contiguously (at 2 ranks rank 0 holds x's, rank 1 z's), so the product
    ``x @ in_proj`` is gathered whole and each rank takes channels [lo, hi)
    of x and of z (the gather's backward reduce-scatters their gradients
    home). The scan runs on the rank's channels, and the ranks' outputs
    through their rows of ``out_proj`` are summed."""
    di = cfg.d_inner
    split = p["in_proj"].shape[1] != 2 * di
    if split:
        lo, hi = tp.local_range(di)
        xz = tp.gather_from_model(tp.copy_to_model(x) @ p["in_proj"], -1)
        xin, z = xz[..., lo:hi], xz[..., di + lo:di + hi]
    else:
        xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc, _ = _causal_conv(xin, p["conv"])
    xc = F.silu(xc)
    y, _ = _mamba_core(p, xc, z, cfg)
    out = y @ p["out_proj"]
    return tp.reduce_from_model(out) if split else out


def mamba_make_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((batch, k - 1, di), dtype=dtype, device=device),
            "h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device)}


def _model_rows(n: int, split: bool) -> slice:
    """The rows of ``n`` (d_inner or d_model) that this rank's leaves hold
    over 'model' where the rules split them, else all."""
    return slice(*tp.local_range(n)) if split else slice(0, n)


def _to_weight_rows(t: torch.Tensor, axes, rows: slice) -> torch.Tensor:
    """``t`` (B, chunk), this rank's chunk over ``axes`` of a state's
    channels, as the channels ``rows`` that its weights' rows take: the
    chunk itself where the two are one (the state over 'model', or whole
    with whole weights), else gathered whole (a token's activations) and
    cut."""
    if rows.stop - rows.start == t.shape[-1]:
        return t
    return (tp.gather_over(t, -1, axes) if axes else t)[:, rows]


def mamba_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, D). Returns (out (B, D), cache), the cache updated in place.

    Under tensor parallelism (the leaves split as in :func:`mamba_apply`)
    the cache holds this rank's chunk of d_inner, in a layout of
    ``launch.shardings.cache_pspec``: the channels over 'model' (those of
    its weights' rows), or with batch 1 over every axis
    (``tp.split_axes``). Each rank steps its chunk's channels only: ``x @
    in_proj`` gathered whole over 'model' (a token's [x | z]), the chunk's
    conv and ``ops.mamba_step`` on its state, with its rows of ``conv``,
    ``A_log`` and ``D`` (``tp.rows_for``: at batch 1 a chunk lies in
    another rank's slice of them, and only its rows are sent); its partial
    ``xc @ x_proj`` summed over 'model' gives (dt_r, B, C), dt comes from
    its columns of ``dt_proj``, and its rows of ``out_proj`` take the gated
    output, summed over 'model'. At batch 1 the chunk's xc, the slice's dt
    and the chunk's gated output are gathered (a token's activations) to
    meet the weights' rows. No state leaf and no whole weight moves."""
    di, r, n = cfg.d_inner, cfg.dt_rank, cfg.ssm_state
    split = p["in_proj"].shape[1] != 2 * di
    axes = tp.split_axes(di, cache["conv"].shape[-1])
    lo, hi = tp.chunk_range(di, axes)
    rows = _model_rows(di, split)
    xz = x @ p["in_proj"]
    if split:
        xz = tp.gather_from_model(xz, -1)
    xin, z = xz[:, lo:hi], xz[:, di + lo:di + hi]
    conv, A_log, D = tp.rows_for([p["conv"], p["A_log"], p["D"]], di, axes)
    xc, conv_state = _conv_step(xin, conv, cache["conv"])
    xc = F.silu(xc)
    proj = _to_weight_rows(xc, axes, rows) @ p["x_proj"]
    if split:
        proj = tp.reduce_from_model(proj)
    dt_r, Bm, Cm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"][rows])
    if rows != slice(lo, hi):
        dt = (tp.gather_from_model(dt, -1) if split else dt)[:, lo:hi]
    A = -torch.exp(A_log)
    y, h = ops.mamba_step(xc, dt, A, Bm, Cm, D, cache["h"])
    out = _to_weight_rows(y * F.silu(z), axes, rows) @ p["out_proj"]
    if split:
        out = tp.reduce_from_model(out)
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
    """Prefill mLSTM, x: (B, S, D) -> (B, S, D).

    Tensor parallelism (:mod:`.tensor_parallel`) is read from the leaves:
    where ``in_proj`` holds fewer than its 2 d_inner columns, ``conv``,
    ``wq``, ``wk``, ``wv`` and ``out_proj`` hold this rank's rows [lo, hi)
    of d_inner, and ``norm``, ``w_gates`` and ``gate_bias`` are whole (the
    rules' split). As in :func:`mamba_apply`, ``x @ in_proj`` is gathered
    whole (its [x | z] columns are split contiguously) and each rank takes
    channels [lo, hi) of x and of z and runs the conv on them. Its rows of
    ``wq`` / ``wk`` / ``wv`` give partial q / k / v over the whole d_inner,
    summed over 'model' in one all-reduce; the chunked recurrence and the
    RMSNorm over d_inner then run whole on every rank (so the heads need
    not split). The rank's channels of h, gated by z, go through its rows
    of ``out_proj``, and the ranks' outputs are summed. Every whole tensor
    that enters that work (x, the summed q / k / v, ``w_gates``,
    ``gate_bias`` and the norm's scale) goes through ``copy_to_model``: each
    rank's gradient of it is partial, and the sum is the whole one."""
    b, s, d = x.shape
    hh = cfg.n_heads
    di = cfg.d_inner
    dh = di // hh
    w_gates, gate_bias, norm = p["w_gates"], p["gate_bias"], p["norm"]
    split = p["in_proj"].shape[1] != 2 * di
    if split:
        lo, hi = tp.local_range(di)
        x = tp.copy_to_model(x)
        xz = tp.gather_from_model(x @ p["in_proj"], -1)
        xin, z = xz[..., lo:hi], xz[..., di + lo:di + hi]
        w_gates, gate_bias, norm = (tp.copy_to_model(t)
                                    for t in (w_gates, gate_bias, norm))
    else:
        xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc, _ = _causal_conv(xin, p["conv"])
    xc = F.silu(xc)
    qkv = (xc @ p["wq"], xc @ p["wk"], xin @ p["wv"])
    if split:
        # the ranks' partial products over their rows of d_inner, summed
        qkv = tp.copy_to_model(tp.reduce_from_model(
            torch.cat(qkv, dim=-1))).split(di, dim=-1)
    q, k, v = (t.reshape(b, s, hh, dh).transpose(1, 2) for t in qkv)
    gates = x.float() @ w_gates + gate_bias
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
    h = rmsnorm(h.to(x.dtype), norm, cfg.norm_eps)
    if split:
        return tp.reduce_from_model((h[..., lo:hi] * F.silu(z)) @ p["out_proj"])
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
    """x: (B, D). Returns (out (B, D), cache), the cache updated in place.

    Under tensor parallelism (the leaves split as in :func:`mlstm_apply`)
    ``conv`` holds this rank's chunk of d_inner (over 'model', or with
    batch 1 over every axis, stepped with its rows of the conv weight as
    in :func:`mamba_decode`), ``C`` (B, H, dh, dh), whose last dim is the
    keys' (C = sum of v k^T), its slice of that dim over 'model', and ``n``
    / ``m`` are whole. Each rank's rows of ``wq`` / ``wk`` / ``wv`` give
    partial q / k / v over the whole d_inner, summed in one all-reduce (xc
    gathered first where its chunk is not those rows); the gates, ``n``
    and ``m`` run whole on every rank; its key columns of ``C`` are
    updated with its columns of k, and C q over them is summed over
    'model' (a token's numerator, (B, d_inner)). The norm over the whole
    d_inner follows on every rank, and its rows of ``out_proj`` take its
    channels, summed over 'model'."""
    b, d = x.shape
    hh = cfg.n_heads
    di = cfg.d_inner
    dh = di // hh
    split = p["in_proj"].shape[1] != 2 * di
    axes = tp.split_axes(di, cache["conv"].shape[-1])
    lo, hi = tp.chunk_range(di, axes)
    rows = _model_rows(di, split)
    xz = x @ p["in_proj"]
    if split:
        xz = tp.gather_from_model(xz, -1)
    xin, z = xz.split(di, dim=-1)
    conv, = tp.rows_for([p["conv"]], di, axes)
    xc, conv_state = _conv_step(xin[:, lo:hi], conv, cache["conv"])
    xc = F.silu(_to_weight_rows(xc, axes, rows))
    qkv = (xc @ p["wq"], xc @ p["wk"], xin[:, rows] @ p["wv"])
    if split:
        qkv = tp.reduce_from_model(torch.cat(qkv, dim=-1)).split(di, dim=-1)
    q, k, v = (t.reshape(b, hh, dh).float() for t in qkv)
    gates = x.float() @ p["w_gates"] + p["gate_bias"]
    logf = F.logsigmoid(gates[..., :hh])
    logi = gates[..., hh:]
    m = torch.maximum(logf + cache["m"], logi)
    fc = torch.exp(logf + cache["m"] - m)
    ic = torch.exp(logi - m)
    scale = dh ** -0.5
    keys = slice(*tp.chunk_range(dh, tp.split_axes(dh, cache["C"].shape[-1])))
    C = fc[..., None, None] * cache["C"] + ic[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k[..., keys])
    n = fc[..., None] * cache["n"] + ic[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", C, q[..., keys]) * scale
    if keys.stop - keys.start != dh:
        num = tp.reduce_from_model(num)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q) * scale),
                        torch.exp(-m))
    h = (num / den[..., None]).reshape(b, di)
    h = rmsnorm(h.to(x.dtype), p["norm"], cfg.norm_eps)
    out = (h[:, rows] * F.silu(z[:, rows])) @ p["out_proj"]
    if split:
        out = tp.reduce_from_model(out)
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
    """Sequential loop over time (non-associative recurrence).

    Tensor parallelism (:mod:`.tensor_parallel`) is read from the leaves:
    where ``w`` holds fewer than its 4 D columns, it holds this rank's
    slice of [i | f | z | o] (split contiguously, as ``in_proj`` in
    :func:`mamba_apply`) and ``out_proj`` its rows of D; ``r`` and ``b``
    are whole. ``x @ w`` is gathered whole (the gather's backward sums the
    ranks' partial gradients of it), the time loop runs whole on every rank
    with ``r`` and ``b`` through ``copy_to_model``, and the rank's channels
    of h go through its rows of ``out_proj``; the ranks' outputs are
    summed."""
    b, s, d = x.shape
    split = p["w"].shape[1] != 4 * d
    if split:
        wx = tp.gather_from_model(tp.copy_to_model(x) @ p["w"], -1)
        p = dict(p, r=tp.copy_to_model(p["r"]), b=tp.copy_to_model(p["b"]))
    else:
        wx = x @ p["w"]                                        # (B,S,4D)
    state = tuple(torch.zeros((b, d), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    cut = CUT_LOOP if CUT_LOOP is not None and is_fake(x) else None
    n, wx = (s, wx) if cut is None else cut.begin(wx, s)
    for t in range(n):
        h, state = _slstm_cell(p, wx[:, t], state, cfg)
        hs.append(h)
        if cut is not None:
            cut.after_step()
    if cut is None:
        h = torch.stack(hs, dim=1).to(x.dtype)
    else:
        h = cut.stack(hs, s).to(x.dtype)
        cut.end()
    if split:
        lo, hi = tp.local_range(d)
        return tp.reduce_from_model(h[..., lo:hi] @ p["out_proj"])
    return h @ p["out_proj"]


def slstm_make_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    d = cfg.d_model
    return {key: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for key in ("h", "c", "n", "m")}


def slstm_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, D). Returns (out (B, D), cache), the cache updated in place.

    Under tensor parallelism (the leaves split as in :func:`slstm_apply`)
    ``h`` and ``c`` hold this rank's chunk of d_model (over 'model', or
    with batch 1 over every axis) and ``n`` / ``m`` are whole: ``x @ w``
    and the chunks of h and c (one tensor: a token's, (2, B, D)) are
    gathered whole, the cell runs whole on every rank, as the loop of
    :func:`slstm_apply` does, and each rank keeps its chunks of the new h
    and c; its rows of ``out_proj`` take its channels of h, summed over
    'model'."""
    d = cfg.d_model
    split = p["w"].shape[1] != 4 * d
    axes = tp.split_axes(d, cache["h"].shape[-1])
    lo, hi = tp.chunk_range(d, axes)
    wx = x @ p["w"]
    if split:
        wx = tp.gather_from_model(wx, -1)
    hc = torch.stack([cache["h"], cache["c"]])
    if axes:
        hc = tp.gather_over(hc, -1, axes)
    h, (h2, c, n, m) = _slstm_cell(p, wx, (hc[0], hc[1], cache["n"], cache["m"]),
                                   cfg)
    rows = _model_rows(d, split)
    out = h.to(x.dtype)[:, rows] @ p["out_proj"]
    if split:
        out = tp.reduce_from_model(out)
    return out, _update(cache, {"h": h2[:, lo:hi], "c": c[:, lo:hi], "n": n,
                                "m": m})
