"""Megatron-style tensor parallelism over the mesh's 'model' axis.

The reference has no counterpart: there GSPMD splits what the sharding
rules (``launch/shardings.py``) put on 'model' and inserts the collectives
itself. The port's layers hold each rank's slices of those leaves (the
rules' placements, ``layout.local_shard``) and move activations between the
ranks of the 'model' axis through the three autograd functions here:

* :func:`copy_to_model`: the identity; its backward all-reduces the
  gradient. It stands where a tensor replicated over 'model' (a block's
  input, a weight left whole) enters work that each rank does on its own
  slice, so each rank's partial gradient becomes the whole one.
* :func:`reduce_from_model`: an all-reduce (sum); its backward is the
  identity. It ends that work: the ranks' partial outputs -> the output,
  replicated over 'model'.
* :func:`gather_from_model`: an all-gather of the ranks' slices of a dim;
  its backward reduce-scatters the gradient (each rank's is partial there:
  the work after the gather is split again before its reduce), or, with
  ``whole_grad`` (the work after it runs whole on every rank, as DeepSeek's
  MTP block after its ``proj``), takes this rank's slice of it.

Activations between blocks are replicated over 'model'. Each function reads
the mesh that :mod:`.partitioning` registers and goes through
:mod:`repro_torch.collectives` (or ``torch.distributed`` for the sums); with
no mesh, or a 'model' axis of 1, it returns its input untouched and runs no
collective. Like :mod:`repro_torch.layout`, this module imports nothing of
``launch/``.

``counts`` counts this rank's collectives over 'model', forward and backward
alike: ``all_reduce`` (the sums of :func:`reduce_from_model`,
:func:`max_over_model` and :func:`copy_to_model`'s backward),
``all_gather`` (:func:`gather_from_model`) and ``reduce_scatter`` (its
backward), each beside ``<kind>_bytes``, the bytes of the whole tensor (the
sum's, the gathered one's, the one scattered). The caller resets it
(``counts.clear()``). :func:`collectives_per_step` says what it should hold
after one train step of a config: the design, which the tests and the
card's runs hold ``counts`` to.
"""
from __future__ import annotations

import collections
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.layout import coordinate, mesh_shape
from . import partitioning as part

AXIS = "model"

counts = collections.Counter()


def _count(kind: str, t: torch.Tensor) -> None:
    counts[kind] += 1
    counts[f"{kind}_bytes"] += t.numel() * t.element_size()


def model_size() -> int:
    """The size of the registered mesh's 'model' axis (1 with no mesh)."""
    mesh = part.current_mesh()
    return 1 if mesh is None else mesh_shape(mesh).get(AXIS, 1)


def model_index() -> int:
    """This rank's index along 'model' (0 with no mesh)."""
    if model_size() == 1:
        return 0
    return coordinate(part.current_mesh(), (AXIS,))[0]


def local_range(n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's part of ``n`` items split over 'model', as
    ``layout.local_shard`` splits them (the rules split only a dim that
    'model' divides)."""
    step = n // model_size()
    lo = model_index() * step
    return lo, lo + step


def own_heads(split, h: int, hkv: int, m: int) -> bool:
    """Whether each of the ``m`` ranks of 'model' runs its own heads of an
    attention with ``h`` / ``hkv`` heads whose projections are split as
    ``split`` says (a flag a leaf: this rank holds a slice of it): every
    projection split and ``m`` dividing both head counts. Otherwise every
    rank runs every head, the split projections gathered whole, as GSPMD
    runs the reference."""
    return all(split) and h % m == 0 and hkv % m == 0


def _group():
    return part.current_mesh().get_group(AXIS)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _count("all_reduce", g)
        dist.all_reduce(g, group=_group())
        return g


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        _count("all_reduce", out)
        dist.all_reduce(out, group=_group())
        return out

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, whole_grad: bool):
        ctx.dim, ctx.whole_grad = dim, whole_grad
        out = collectives.gather_dim(x, dim, _group(), model_size())
        _count("all_gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.whole_grad:
            lo, hi = local_range(g.shape[ctx.dim])
            return g.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None
        _count("reduce_scatter", g)
        return (collectives.scatter_dim(g, ctx.dim, _group(), model_size()),
                None, None)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over 'model') as the input of per-rank work: the
    gradient that comes back is summed over 'model'."""
    return x if model_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over 'model' of every rank's ``x`` (a new tensor)."""
    return x if model_size() == 1 else _ReduceFromModel.apply(x)


def gather_from_model(x: torch.Tensor, dim: int,
                      whole_grad: bool = False) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's slice of dim ``dim``
    (equal slices, in rank order). Its gradient is summed over 'model'
    (each rank's is its part), or with ``whole_grad`` taken as it is (each
    rank's is the whole one)."""
    return x if model_size() == 1 else _GatherFromModel.apply(
        x, dim % x.dim(), whole_grad)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over 'model' of every rank's ``x``, with no
    gradient (``x`` detached with no 'model' axis)."""
    if model_size() == 1:
        return x.detach()
    out = x.detach().clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group())
    return out


def combine_partials(out: torch.Tensor, lse: torch.Tensor,
                     axes: Tuple[str, ...]) -> torch.Tensor:
    """Attention over a cache split over the mesh ``axes``: each rank's
    ``out`` (B, H, D) and log-sum-exp ``lse`` (B, H) float32 over its slice
    (-inf where it holds no valid slot) -> the output over the whole cache,
    the same on every rank. One all-gather an axis brings every rank's
    (out, L) of the axis, which are weighted by exp(L - max L) and summed,
    as the decode kernel's blocks combine within a cluster; the combined
    (out, L) goes on to the next axis. No gradient (serving); a gather over
    'model' is counted in :data:`counts`."""
    mesh = part.current_mesh()
    shape = mesh_shape(mesh)
    axes = [a for a in axes if shape.get(a, 1) > 1]
    if not axes:
        return out
    both = torch.cat([out.float(), lse[..., None]], dim=-1)
    for a in axes:
        every = collectives.gather_dim(both.unsqueeze(0), 0, mesh.get_group(a),
                                       shape[a])
        if a == AXIS:
            _count("all_gather", every)
        outs, lses = every[..., :-1], every[..., -1]
        top = lses.amax(dim=0)
        w = torch.exp(lses - torch.where(torch.isfinite(top), top, 0.0))
        den = w.sum(dim=0)
        num = (outs * w[..., None]).sum(dim=0)
        merged = torch.where(den[..., None] > 0,
                             num / torch.clamp(den[..., None], min=1e-30), 0.0)
        both = torch.cat([merged, (top + torch.log(den))[..., None]], dim=-1)
    return both[..., :-1].to(out.dtype)


def refuse_decode(cfg, what: str) -> None:
    """NotImplementedError where a 'model' axis above 1 is registered: the
    decode of ``what`` does not run split over 'model' (ROADMAP item 6g2);
    it never runs on whole weights in its place."""
    m = model_size()
    if m > 1:
        raise NotImplementedError(
            f"{cfg.name}: {what} decode under a 'model' axis of {m} is not "
            "ported (ROADMAP item 6g2: decode under a mesh for MLA, Mamba, "
            "mLSTM / sLSTM and whisper)")


def collectives_per_step(cfg, m: int, seq: int) -> dict:
    """The collectives over 'model' of one train step of ``cfg`` at a
    'model' axis of ``m`` (:data:`counts`: all-reduces,
    all-gathers, reduce-scatters), as the port's layers run them where the
    rules split a leaf (a width that ``m`` divides). A block: attention
    with each rank its heads sums its output (forward) and x's gradient
    (backward); with every head on every rank it also gathers each split
    wq / wk / wv (forward; their reduce-scatters backward) and sums the
    gradient of a whole one; MLA gathers its two latents and sums its
    output (backward: the reduce-scatters, and the sums of x's, wkr's and
    the two norms' gradients); Mamba gathers x @ in_proj and sums (dt_r, B,
    C) and its output (backward: the reduce-scatter, and the sums of x's,
    (dt_r, B, C)'s and dt_bias's gradients); mLSTM gathers x @ in_proj and
    sums q / k / v (one tensor) and its output (backward: the
    reduce-scatter, and the sums of x's, q / k / v's, the norm's, w_gates'
    and gate_bias' gradients); sLSTM gathers x @ w and sums its output
    (backward: the reduce-scatter, and the sums of x's, r's and b's
    gradients); a split SwiGLU sums its output and x's gradient; a split
    MoE sums its output and, backward, the tokens' and each dispatch
    group's weights' gradients (a split shared expert as a SwiGLU). An
    encoder-decoder: each encoder layer an attention and a SwiGLU block,
    each decoder layer self attention, cross attention (as attention, its
    q side: the output summed, x's gradient summed; every head on every
    rank gathers a split wq) and a SwiGLU, and ``cross_kv`` once a step
    (backward: the encoder states' gradient summed; every head on every
    rank gathers split wk / wv). A vocab split sums the embedding lookup
    (the decoder's; a vlm's text rows, which its trainer looks up outside
    the step, count as one), and each 256-position chunk of the loss's
    maximum and sums, and backward h's gradient. MTP adds its lookup, its
    ``proj``'s gather (forward only: its block's gradient is whole on every
    rank) and the sum of its input's gradient, its block and its loss over
    S - 1 positions. Remat runs each period's (an encoder-decoder's each
    layer's) forward again in the backward, up to its last saved tensor
    (``torch.utils.checkpoint``'s early stop): all but its closing sum; the
    dense prefix and MTP run once."""
    zero = collections.Counter

    def swiglu(width):
        return (zero(all_reduce=1), zero(all_reduce=1)) if width % m == 0 else (zero(), zero())

    def attn_split():
        """Which of wq / wk / wv the rules split, and whether each rank
        runs its heads."""
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        split = [(h * hd) % m == 0] + [(hkv * hd) % m == 0] * 2
        return split, own_heads(split, h, hkv, m)

    def mixer(kind):
        if kind == "attn":
            split, own = attn_split()
            if not any(split):
                return zero(), zero()
            fwd, bwd = zero(all_reduce=1), zero(all_reduce=1)
            if not own:
                fwd["all_gather"] += sum(split)
                bwd["reduce_scatter"] += sum(split)
                bwd["all_reduce"] += 3 - sum(split)
            return fwd, bwd
        if kind == "mla":
            widths = (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.n_heads)
            if any(w % m for w in widths):
                raise ValueError(f"{cfg.name}'s MLA widths {widths} at {m} ranks of 'model'")
            return zero(all_gather=2, all_reduce=1), zero(reduce_scatter=2, all_reduce=4)
        if kind == "mamba":
            if cfg.d_inner % m:
                return zero(), zero()
            return zero(all_gather=1, all_reduce=2), zero(reduce_scatter=1, all_reduce=3)
        if kind == "mlstm":
            if cfg.d_inner % m:
                return zero(), zero()
            return zero(all_gather=1, all_reduce=2), zero(reduce_scatter=1, all_reduce=5)
        if kind == "slstm":
            if cfg.d_model % m:
                return zero(), zero()
            return zero(all_gather=1, all_reduce=1), zero(reduce_scatter=1, all_reduce=3)
        raise ValueError(f"no count for the {kind} mixer")

    def cross():
        """Cross attention's q side a layer (wq is split wherever wk is),
        and ``cross_kv`` once."""
        split, own = attn_split()
        if not any(split):
            return (zero(), zero()), (zero(), zero())
        q = (zero(all_reduce=1), zero(all_reduce=1))
        kv = (zero(), zero(all_reduce=1))
        if not own:
            q[0]["all_gather"] += 1
            q[1]["reduce_scatter"] += 1
            kv[0]["all_gather"] += sum(split[1:])
            kv[1]["reduce_scatter"] += sum(split[1:])
            kv[1]["all_reduce"] += 2 - sum(split[1:])
        return q, kv

    def ffn(kind, width=None):
        if kind is None:
            return zero(), zero()
        if kind == "mlp":
            return swiglu(width or cfg.d_ff)
        fwd, bwd = zero(), zero()
        if cfg.n_experts % m == 0:
            fwd["all_reduce"] += 1
            bwd["all_reduce"] += 1 + max(1, cfg.moe_dispatch_groups)
        if cfg.n_shared_experts:
            f, b = swiglu(cfg.n_shared_experts * cfg.d_expert)
            fwd, bwd = fwd + f, bwd + b
        return fwd, bwd

    def block(spec):
        (f1, b1), (f2, b2) = mixer(spec[0]), ffn(spec[1])
        return f1 + f2, b1 + b2

    def loss(s):
        if cfg.vocab % m:
            return zero(), zero()
        return zero(all_reduce=2 * -(-s // min(256, s))), zero(all_reduce=1)

    def again(fwd):
        """A checkpointed forward run again in the backward: the recompute
        stops at the last tensor the backward saved, so the closing sum (of
        its last mixer or FFN) does not run again."""
        if not cfg.remat:
            return zero()
        out = fwd.copy()
        if out["all_reduce"]:
            out["all_reduce"] -= 1
        return out

    total = collections.Counter()
    if cfg.is_encdec:
        enc_f, enc_b = block(("attn", "mlp"))
        (q_f, q_b), (kv_f, kv_b) = cross()
        self_f, self_b = mixer("attn")
        mlp_f, mlp_b = swiglu(cfg.d_ff)
        # a decoder layer: self attention, cross attention, the MLP
        dec_f, dec_b = self_f + q_f + mlp_f, self_b + q_b + mlp_b
        for f, b, n in ((enc_f, enc_b, cfg.encoder_layers), (dec_f, dec_b, cfg.n_layers)):
            for _ in range(n):
                total += f + b + again(f)
        total += kv_f + kv_b
    else:
        once = [(cfg.period[0][0], "mlp")] * cfg.first_k_dense
        if cfg.mtp:
            once.append(cfg.period[0])
        for spec in once:
            f, b = block(spec)
            total += f + b
        period_f, period_b = zero(), zero()
        for spec in cfg.period:
            f, b = block(spec)
            period_f, period_b = period_f + f, period_b + b
        for _ in range(cfg.n_periods):
            total += period_f + period_b + again(period_f)
    lookups = 1 + bool(cfg.mtp)
    if cfg.vocab % m == 0:
        total["all_reduce"] += lookups
    for s in [seq] + ([seq - 1] if cfg.mtp else []):
        f, b = loss(s)
        total += f + b
    if cfg.mtp and cfg.d_model % m == 0:
        total += zero(all_gather=1, all_reduce=1)
    return dict(sorted(total.items()))
