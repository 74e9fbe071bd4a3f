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
import math
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
    (out, L) goes on to the next axis. No gradient (serving); each gather
    is counted in :data:`counts`."""
    mesh = part.current_mesh()
    shape = mesh_shape(mesh)
    axes = [a for a in axes if shape.get(a, 1) > 1]
    if not axes:
        return out
    both = torch.cat([out.float(), lse[..., None]], dim=-1)
    for a in axes:
        every = collectives.gather_dim(both.unsqueeze(0), 0, mesh.get_group(a),
                                       shape[a])
        _count_on("all_gather", every, a)
        outs, lses = every[..., :-1], every[..., -1]
        top = lses.amax(dim=0)
        w = torch.exp(lses - torch.where(torch.isfinite(top), top, 0.0))
        den = w.sum(dim=0)
        num = (outs * w[..., None]).sum(dim=0)
        merged = torch.where(den[..., None] > 0,
                             num / torch.clamp(den[..., None], min=1e-30), 0.0)
        both = torch.cat([merged, (top + torch.log(den))[..., None]], dim=-1)
    return both[..., :-1].to(out.dtype)


def split_axes(whole: int, local: int) -> Tuple[str, ...]:
    """The mesh axes that split a dim of ``whole`` items into this rank's
    ``local`` ones, as the rules lay a decode state out
    (``launch.shardings.cache_pspec``): () where it is whole, ('model',),
    or with batch 1 every axis of size above 1, in mesh order. ValueError
    for any other split."""
    if local == whole:
        return ()
    mesh = part.current_mesh()
    shape = {} if mesh is None else mesh_shape(mesh)
    if whole == local * shape.get(AXIS, 1):
        return (AXIS,)
    every = tuple(a for a, n in shape.items() if n > 1)
    if whole == local * math.prod(shape[a] for a in every):
        return every
    raise ValueError(f"a dim of {whole} held as {local} on a mesh {shape}: "
                     "not a layout of the decode rules")


def _count_on(kind: str, t: torch.Tensor, axis: str) -> None:
    """:data:`counts` of a collective over ``axis``: ``kind`` over 'model',
    ``kind:axis`` over another axis."""
    _count(kind if axis == AXIS else f"{kind}:{axis}", t)


def gather_over(x: torch.Tensor, dim: int, axes: Tuple[str, ...]
                ) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's chunk of dim ``dim``
    over ``axes`` (chunks in the order of the ranks' coordinate over them,
    the first axis slowest, as ``layout.local_shard`` cuts them): one
    all-gather an axis, the last first. No gradient (serving); counted in
    :data:`counts`."""
    mesh = part.current_mesh()
    shape = mesh_shape(mesh)
    for a in reversed(axes):
        x = collectives.gather_dim(x, dim % x.dim(), mesh.get_group(a),
                                   shape[a])
        _count_on("all_gather", x, a)
    return x


def chunk_range(n: int, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """[lo, hi) of this rank's chunk of ``n`` items split over ``axes``
    (:func:`split_axes`; the whole of them with none)."""
    index, count = coordinate(part.current_mesh(), axes) if axes else (0, 1)
    return index * (n // count), (index + 1) * (n // count)


def rows_for(ws, n: int, axes: Tuple[str, ...]) -> list:
    """Rows [lo, hi) of each leaf of ``ws``: this rank's chunk of dim 0 of
    ``n`` rows over ``axes`` (:func:`split_axes`), where each leaf holds
    all ``n`` rows or this rank's slice of them over 'model' (the rules'
    split of a weight). Whole leaves and chunks within this rank's slice
    are cut here. With batch 1 a decode state's chunks are finer than the
    weights' slices and lie across them (chunk q of every axis holds rows
    that slice q // (chunks a slice) of 'model' holds): there every rank
    of a 'model' group sends the rows that the others' chunks want of its
    slice, all leaves in one float32 message a peer, and receives its own
    (``collectives.p2p``; :data:`counts` 'permute' once a call, its bytes
    this rank's sent and received). Only a chunk's rows move, never a
    whole leaf. No gradient (serving)."""
    lo, hi = chunk_range(n, axes)
    c = hi - lo
    m, me = model_size(), model_index()
    out, split = list(ws), [i for i, w in enumerate(ws) if w.shape[0] != n]
    for i, w in enumerate(ws):
        if i not in split:
            out[i] = w[lo:lo + c]
    if not split:
        return out
    per = n // m
    if axes[-1:] != (AXIS,) or per % c:
        raise ValueError(f"rows_for: a chunk of {c} of {n} rows over {axes} "
                         f"against slices of {per} over 'model'")
    if axes == (AXIS,):
        return [w if i in split else out[i] for i, w in enumerate(ws)]
    outer = lo // c // m

    def flat(w, start):
        return w[start:start + c].reshape(c, -1).float()

    sends = []
    for peer in range(m):
        start = (outer * m + peer) * c
        if peer != me and start // per == me:
            sends.append((torch.cat([flat(ws[i], start - me * per)
                                     for i in split], dim=1), peer))
    owner = lo // per
    widths = [ws[i][0].numel() for i in split]
    if owner == me:
        got = torch.cat([flat(ws[i], lo - me * per) for i in split], dim=1)
        recvs = []
    else:
        got = torch.empty((c, sum(widths)), dtype=torch.float32,
                          device=ws[split[0]].device)
        recvs = [(got, owner)]
    collectives.p2p(sends, recvs, _group())
    counts["permute"] += 1
    counts["permute_bytes"] += sum(t.numel() * 4 for t, _ in sends + recvs)
    for i, part_ in zip(split, got.split(widths, dim=1)):
        w = ws[i]
        out[i] = part_.reshape((c,) + tuple(w.shape[1:])).to(w.dtype)
    return out


def collectives_per_decode_step(cfg, mesh_shape: dict, batch: int) -> dict:
    """The collectives of one decode step of ``cfg`` on one rank of a mesh
    of ``mesh_shape`` (``{axis: size}``) serving ``batch`` rows
    (:data:`counts`, by kind: 'all_reduce', 'all_gather' over 'model',
    'all_gather:<axis>' over another axis, 'permute' for
    :func:`rows_for`'s exchange), as the decoders run them on the rules'
    layouts of the params and caches (the caches' lengths taken to divide
    as the rules would split them). The rows split over the batch axes
    where they divide the batch (``cache_pspec``'s ``b_ok``), and then a
    cache's KV heads, its length or a state's channels go over 'model';
    otherwise (batch 1) the length or the channels go over every axis, MLA's
    length over ('data', 'model'). A layer: attention with each rank its KV
    heads sums its output; with the length split, the split projections'
    columns of the token are gathered, each length axis gathers the
    partials (``combine_partials``), and a split output is summed. MLA
    gathers its two latents and the queries of every head, each length
    axis the partials, and sums its output. Mamba gathers x @ in_proj and
    sums (dt_r, B, C) and its output; with its channels over more than
    'model', it also gathers its chunk's xc and gated output over each of
    those axes, dt over 'model', and exchanges its rows of the per-channel
    weights. mLSTM gathers x @ in_proj and sums q / k / v, C q and its
    output; with its conv's channels over more than 'model', it gathers xc
    over those axes and exchanges its conv rows. sLSTM gathers x @ w and
    its chunks of h and c over their axes, and sums its output. A split
    SwiGLU or MoE sums its output (the shared expert as a SwiGLU). The
    encoder-decoder's layer: self attention, cross attention (its heads'
    output summed; every head on every rank gathers the token's q first)
    and the MLP. A vocab split sums the lookup and gathers the logits."""
    shape = {a: n for a, n in mesh_shape.items()}
    m = shape.get(AXIS, 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    rows = math.prod(shape[a] for a in batch_axes)
    rows_split = batch % rows == 0 and batch >= rows
    every = tuple(a for a, n in shape.items() if n > 1)
    total = collections.Counter()

    def gathers(axes):
        return collections.Counter(
            "all_gather" if a == AXIS else f"all_gather:{a}"
            for a in axes if shape.get(a, 1) > 1)

    def over(n, axes):
        """``axes`` where they divide ``n`` (the rules' guard), else ()."""
        axes = tuple(a for a in axes if shape.get(a, 1) > 1)
        return axes if n % math.prod(shape[a] for a in axes) == 0 else ()

    def state_axes(n):
        return over(n, (AXIS,) if rows_split else every)

    def attn():
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        split = [(h * hd) % m == 0 and m > 1] + [(hkv * hd) % m == 0 and m > 1] * 2
        out = collections.Counter()
        if rows_split and m > 1 and hkv % m == 0:
            out["all_reduce"] += 1
            return out
        if any(split):
            out["all_gather"] += 1
            out["all_reduce"] += 1
        return out + gathers((AXIS,) if rows_split else every)

    def mla():
        split = m > 1
        out = gathers((AXIS,) if rows_split else ("data", AXIS))
        if split:
            out += collections.Counter(all_gather=3, all_reduce=1)
        return out

    def mamba():
        split = m > 1 and cfg.d_inner % m == 0
        axes = state_axes(cfg.d_inner)
        out = collections.Counter()
        if split:
            out += collections.Counter(all_gather=1, all_reduce=2)
        if axes not in ((), (AXIS,)):
            out += gathers(axes) + gathers(axes)
            if split:
                out += collections.Counter(all_gather=1, permute=1)
        return out

    def mlstm():
        split = m > 1 and cfg.d_inner % m == 0
        axes = state_axes(cfg.d_inner)
        out = collections.Counter()
        if split:
            out += collections.Counter(all_gather=1, all_reduce=2)
            if (cfg.d_inner // cfg.n_heads) % m == 0:
                out["all_reduce"] += 1
        if axes not in ((), (AXIS,)):
            out += gathers(axes)
            if split:
                out["permute"] += 1
        return out

    def slstm():
        split = m > 1 and cfg.d_model % m == 0
        out = gathers(state_axes(cfg.d_model))
        if split:
            out += collections.Counter(all_gather=1, all_reduce=1)
        return out

    def swiglu(width):
        return collections.Counter(all_reduce=int(m > 1 and width % m == 0))

    def ffn(kind):
        if kind is None:
            return collections.Counter()
        if kind == "mlp":
            return swiglu(cfg.d_ff)
        out = collections.Counter(all_reduce=int(m > 1 and cfg.n_experts % m == 0))
        if cfg.n_shared_experts:
            out += swiglu(cfg.n_shared_experts * cfg.d_expert)
        return out

    mixers = {"attn": attn, "mla": mla, "mamba": mamba, "mlstm": mlstm,
              "slstm": slstm}
    if cfg.is_encdec:
        h, hd = cfg.n_heads, cfg.hd
        cross = collections.Counter()
        if m > 1 and (h * hd) % m == 0:
            cross["all_reduce"] += 1
            if not (h % m == 0 and cfg.n_kv_heads % m == 0 and
                    (cfg.n_kv_heads * hd) % m == 0):
                cross["all_gather"] += 1
        layer = attn() + cross + swiglu(cfg.d_ff)
        for _ in range(cfg.n_layers):
            total += layer
    else:
        for _ in range(cfg.first_k_dense):
            total += mixers[cfg.period[0][0]]() + ffn("mlp")
        for _ in range(cfg.n_periods):
            for mixer, kind in cfg.period:
                total += mixers[mixer]() + ffn(kind)
    if m > 1 and cfg.vocab % m == 0:
        total["all_reduce"] += 1
        total["all_gather"] += 1
    return dict(sorted((k, v) for k, v in total.items() if v))


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
