"""Plain PyTorch versions of the kernels: the semantic references.

Counterpart of :mod:`repro.kernels.ref`, with the same signatures and the
same float32 internals.  Each one sits beside its kernel (the kernel modules
re-export it as ``*_plain``); the CPU path runs them, and ``chip_smoke.py``
holds every kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """Gradients of :func:`rmsnorm_ref`, as explicit float32 formulas:
    with r = rsqrt(mean(x^2) + eps), dx = r * (scale * dy - x * r^2 *
    mean(scale * dy * x)) in x's dtype, and dscale = the sum over rows of
    dy * x * r, float32 of shape (d,)."""
    d = x.shape[-1]
    x32, dy32, s = x.float(), dy.float(), scale.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gs = dy32 * s
    dot = (gs * x32).mean(dim=-1, keepdim=True)
    dx = r * (gs - x32 * (r * r) * dot)
    dscale = (dy32 * x32 * r).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale


def _mask(sq: int, skv: int, causal: bool, window: Optional[int],
          offset: int, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask. ``offset`` = absolute position of q row 0
    minus that of kv row 0 (for caches/prefill continuation)."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  offset: int = 0, scale: Optional[float] = None,
                  return_lse: bool = False):
    """Naive attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); GQA via
    head-group broadcast. Returns (B, Hq, Sq, D); with ``return_lse`` also
    L, (B, Hq, Sq) float32: the log-sum-exp over the visible keys of each
    row's scaled logits, +inf for a row that sees no key (so that
    ``exp(scale * s - L)`` is 0 there, as the kernels' output is)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    m = _mask(sq, skv, causal, window, offset, device=q.device)
    logits = torch.where(m[None, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.masked_fill(~m, float("-inf")), dim=-1)
    lse = lse.masked_fill(~m.any(dim=-1), float("inf"))
    return out, lse.reshape(b, hq, sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                      window: Optional[int] = None, offset: int = 0,
                      scale: Optional[float] = None,
                      lse: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of masked softmax attention (shapes and GQA as
    :func:`attention_ref`) as explicit float32 formulas: P = softmax of the
    masked logits, dP = dO V^T, delta = rowsum(dO * O), dS = P (dP - delta),
    dq = scale dS K, dk = scale dS^T Q summed over the G q heads of a kv
    head, dv = P^T dO likewise. ``o`` is the forward's output as stored (its
    rounding enters delta, as in the kernel). A row whose every key is
    masked has P = 0 (the kernels' forward returns 0 there) and contributes
    nothing. With ``lse`` ((B, Hq, Sq), as :func:`attention_ref` returns
    it) P = exp(scale * s - L) of the visible keys, as the bf16 kernel takes
    it, instead of a softmax of its own. Outputs in the inputs' dtypes."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).float()
    dog = do.reshape(b, hkv, g, sq, d).float()
    og = o.reshape(b, hkv, g, sq, d).float()
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    m = _mask(sq, skv, causal, window, offset, device=q.device)
    logits = logits.masked_fill(~m, float("-inf"))
    if lse is not None:
        p = torch.exp(logits - lse.float().reshape(b, hkv, g, sq, 1))
    else:
        mx = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - torch.where(torch.isfinite(mx), mx,
                                           torch.zeros_like(mx)))
        den = e.sum(dim=-1, keepdim=True)
        p = torch.where(den > 0, e / den.clamp_min(1e-30), torch.zeros_like(e))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    delta = (dog * og).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: Optional[torch.Tensor] = None,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, Hq, D); k/v: (B, Hkv, S, D); ``length``: (B,) valid cache length
    (the new token sits at position length-1). Returns (B, Hq, D).
    """
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    kpos = torch.arange(s, device=q.device)[None]
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=q.device)
    length = length.to(q.device)
    valid = kpos < length[:, None]
    if window is not None:
        valid &= kpos > (length[:, None] - 1 - window)
    logits = torch.where(valid[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """Selective state-space scan (Mamba), sequential reference.

    u/dt: (Bt, T, d_in); A: (d_in, N); B/C: (Bt, T, N); D: (d_in,).
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t ;  y_t = C_t . h_t + D u_t
    Returns (y (Bt, T, d_in) in u's dtype, h_T (Bt, d_in, N) float32).
    """
    bt, t, d_in = u.shape
    n = A.shape[1]
    uf, dtf = u.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    Af = A.float()
    h = torch.zeros((bt, d_in, n), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    ys = []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * Af[None])          # (Bt, d_in, N)
        db = dtf[:, i, :, None] * Bf[:, i, None, :]            # (Bt, d_in, N)
        h = da * h + db * uf[:, i, :, None]
        y = torch.einsum("bdn,bn->bd", h, Cf[:, i]) + D * uf[:, i]
        ys.append(y)
    return torch.stack(ys, 1).to(u.dtype), h


def mamba_scan_states_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                          h0: Optional[torch.Tensor] = None, every: int = 16):
    """:func:`mamba_scan_ref` that also returns the float32 state at the
    start of every ``every`` steps, hs (Bt, ceil(T / every), d_in, N): hs[:,
    k] is the state before step k * every (h0 or zeros for k = 0), as the
    scan kernel's training instance saves it for the backward."""
    t = u.shape[1]
    hs, h = [], h0
    ys = []
    for t0 in range(0, t, every):
        hs.append(torch.zeros((u.shape[0], u.shape[2], A.shape[1]), dtype=torch.float32,
                              device=u.device) if h is None else h.float())
        sl = slice(t0, t0 + every)
        y, h = mamba_scan_ref(u[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], D, h)
        ys.append(y)
    return torch.cat(ys, 1), h, torch.stack(hs, 1)


def mamba_scan_bwd_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       dy: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       dh_t: Optional[torch.Tensor] = None):
    """Gradients of :func:`mamba_scan_ref` from dy (Bt, T, d_in) and dh_t
    (Bt, d_in, N; zeros when None), as the explicit reverse recurrence: with
    g_t the gradient of h_t, g_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1} from
    g_T = dh_T; du_t = dt_t sum_n g_t B_t + D dy_t; ddt_t = sum_n g_t (A
    exp(dt_t A) h_{t-1} + B_t u_t); dB_t = sum_d g_t dt_t u_t; dC_t = sum_d
    dy_t h_t; dA = sum_{b,t} g_t dt_t exp(dt_t A) h_{t-1}; dD = sum_{b,t}
    dy_t u_t; dh0 = exp(dt_1 A) g_1. Returns (du, ddt, dA, dB, dC, dD, dh0):
    du, dB, dC in u's dtype, the others float32."""
    bt, t, d_in = u.shape
    n = A.shape[1]
    uf, dtf, dyf = u.float(), dt.float(), dy.float()
    Bf, Cf, Af, Df = B.float(), C.float(), A.float(), D.float()
    h = torch.zeros((bt, d_in, n), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    hs = [h]
    for i in range(t):
        h = torch.exp(dtf[:, i, :, None] * Af) * h \
            + (dtf[:, i, :, None] * Bf[:, i, None, :]) * uf[:, i, :, None]
        hs.append(h)
    g = torch.zeros_like(h) if dh_t is None else dh_t.float()
    du, ddt, dB, dC = ([None] * t for _ in range(4))
    dA = torch.zeros_like(Af)
    for i in reversed(range(t)):
        g = Cf[:, i, None, :] * dyf[:, i, :, None] + g
        e = torch.exp(dtf[:, i, :, None] * Af)
        ge = g * (e * hs[i])
        gB = (g * Bf[:, i, None, :]).sum(-1)
        du[i] = dtf[:, i] * gB + Df * dyf[:, i]
        ddt[i] = (ge * Af).sum(-1) + uf[:, i] * gB
        dB[i] = (g * (dtf[:, i] * uf[:, i])[..., None]).sum(1)
        dC[i] = (dyf[:, i, :, None] * hs[i + 1]).sum(1)
        dA += (dtf[:, i, :, None] * ge).sum(0)
        g = e * g
    return (torch.stack(du, 1).to(u.dtype), torch.stack(ddt, 1), dA,
            torch.stack(dB, 1).to(u.dtype), torch.stack(dC, 1).to(u.dtype),
            (dyf * uf).sum((0, 1)), g)


def sumsq_ref(g: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of one leaf, 0-d."""
    return torch.sum(torch.square(g.float()))


def clip_finalize_ref(partial: torch.Tensor, max_norm: float):
    """(norm, scale) from sums of squares: norm = sqrt(sum), scale =
    min(1, max_norm / max(norm, 1e-9)), float32 0-d tensors."""
    norm = torch.sqrt(partial.float().sum())
    return norm, _clip_scale(norm, max_norm)


def global_norm_scale_ref(grads, max_norm: float):
    """(norm, scale) of the reference's ``clip_by_global_norm`` over a list
    of leaves, with its arithmetic: the sum of each leaf's float32 sum of
    squares, then its square root."""
    norm = torch.sqrt(sum(sumsq_ref(g) for g in grads))
    return norm, _clip_scale(norm, max_norm)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def adamw_update_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
                     c2: torch.Tensor, scale: Optional[torch.Tensor] = None,
                     b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                     weight_decay: float = 0.1) -> None:
    """One AdamW leaf update in place, as the reference's ``upd``: p in its
    storage dtype, m and v float32; lr, c1, c2 (the bias corrections) and
    ``scale`` float32 0-d tensors. With ``scale`` the gradient first takes
    the clip's storage round trip, ``to_dtype(float(g) * scale)``. Weight
    decay applies where p has ndim >= 2 (no decay on norms and biases)."""
    if scale is not None:
        g = (g.float() * scale).to(g.dtype)
    g = g.float()
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    u = (m / c1) / (torch.sqrt(v / c2) + eps)
    if p.dim() >= 2:
        u = u + weight_decay * p.float()
    p.copy_((p.float() - lr * u).to(p.dtype))


def mlp_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Tanh-MLP scoring head: L layers of ``tanh(y @ w[i])`` then a
    feature-sum score.  x: (B, D); w: (L, D, D). Returns (B,) in x's dtype.

    The ``streaming_inference`` app's predictor
    (:mod:`repro_torch.streaming.apps`) runs exactly this, on the card or
    on the CPU.  Each product is a float32 sum over the contraction
    (broadcast multiply, then ``sum``): CUDA-core float32 on every device,
    whatever the global TF32 switch of ``torch.matmul`` says.
    """
    y = x.float()
    for i in range(w.shape[0]):
        y = torch.tanh((y[:, :, None] * w[i].float()[None]).sum(dim=1))
    return y.sum(dim=1).to(x.dtype)
