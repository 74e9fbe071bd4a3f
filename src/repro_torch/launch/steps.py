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

import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.kernels.adamw import global_norm_scale
from repro_torch.launch import shardings as SH
from repro_torch.launch.graphs import GraphedStep
from repro_torch.launch.mesh import fsdp_axis
from repro_torch.layout import coordinate, mesh_shape, named, shard_dim
from repro_torch.models import encdec, model_api, transformer
from repro_torch.models import partitioning as part
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import Optimizer


def _require_on(params, dev: torch.device) -> None:
    where = params["embed"].device
    if where.type != dev.type or (dev.index is not None and where != dev):
        raise ValueError(f"params live on {where}, the step runs on {dev}")


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    clip_norm: float = 1.0, device="cuda",
                    graphs: bool = True, mesh=None,
                    shardings=None) -> Callable:
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

    With a ``mesh`` (:mod:`.mesh`) the step is data-parallel over the axes
    of :func:`_dp_axes`: it takes the global batch and runs its rank's
    rows; the model's loss is this rank's part of the global batch's (the
    token count all-reduced, the aux loss weighted by 1 / ranks), the
    gradients are all-reduced before the clip, and the metrics are the
    global ones. Where ``shardings`` (the params' placements,
    ``shardings.param_shardings``) shard a leaf over ``fsdp_axis(mesh)``,
    it is ZeRO-3: params and AdamW moments stay this rank's slices; the
    step all-gathers the whole tree for the forward and backward,
    reduce-scatters each such gradient, gathers the clip's partial sums of
    squares over the axis in rank order, and updates the slices.

    A 'model' axis above 1 without ``cfg.pure_dp`` is tensor parallelism
    (:mod:`repro_torch.models.tensor_parallel`), for every family (the
    decoders' attention, MLA, Mamba, mLSTM and sLSTM mixers, dense and MoE
    FFNs, the encoder-decoder, the vlm backbone):
    a leaf that ``shardings`` shard over 'model' stays this rank's slice
    of it through the step (ZeRO-3 gathers only its 'data' slice), and so
    do its gradient, with no collective over 'model', and its AdamW
    moments; a leaf replicated over 'model' gets the same gradient on every
    rank of 'model'. The clip's partial sums of squares of a leaf sharded
    over 'model' (or over 'data' and 'model') are gathered over each axis
    in rank order, a replicated leaf's counted once, so every rank gets
    the whole gradient's norm. With no mesh there is no collective.

    ``cfg.seq_shard`` under a 'model' axis above 1 is context parallelism
    (``cfg.pure_dp``, as the reference's ``seq_shard`` configs are; without
    it NotImplementedError: a token split beside tensor parallelism). The
    batch is laid out by the reference's ``input_pspec``: the rows over
    the axes of :func:`_dp_axes`, and, where 'model' divides the sequence,
    the tokens over 'model'. There the step takes its rows and its
    contiguous shard of L = S / M tokens at ``seq_index() * L`` (inputs,
    labels and mask alike), runs the loss under a registered token split
    (``partitioning.use_mesh(..., seq_axis="model")``: attention runs the
    ring), counts the tokens over every axis of the mesh, and all-reduces
    every gradient (its rows, its tokens and the K/V gradients the ring
    pushed home) and the metrics over every axis; a ZeRO-3 leaf is still
    reduce-scattered over ``fsdp_axis`` and all-reduced over the others,
    so the clip sees whole gradients. Where ``pure_dp``'s rows divide
    every axis, the spec puts 'model' on the rows and on the tokens; the
    reference refuses it (``DuplicateSpecError``), and the step raises
    ValueError ("used twice") before any collective.

    On a CUDA device (unless ``graphs=False``) the step is captured in a
    CUDA graph at its first call for a given (params, opt_state) and batch
    shapes: forward, backward (remat included), clip, update and the
    collectives replay as one graph; the batch is copied into the graph's
    buffers and the metrics are the graph's outputs, overwritten by the
    next step."""
    dev = resolve_device(device)
    api = model_api(cfg)
    shape = {} if mesh is None else mesh_shape(mesh)
    seq_split = cfg.seq_shard and shape.get("model", 1) > 1
    if seq_split and not cfg.pure_dp:
        raise NotImplementedError(
            f"{cfg.name}: seq_shard with tensor parallelism over a 'model' "
            f"axis of {shape['model']}; the reference trains seq_shard with "
            "pure_dp only")
    tensor_parallel = shape.get("model", 1) > 1 and not cfg.pure_dp
    f_axis = None if mesh is None else fsdp_axis(mesh)
    f_size = shape.get(f_axis, 1)

    def reduce_grad(g, dim, axes, f_group):
        """The sum over ``axes`` of a whole gradient: this rank's slice of
        it where ``dim`` is its fsdp dim, the whole of it elsewhere."""
        if dim is None:
            return _all_reduce(g, mesh, axes)
        g = SH.scatter_dim(g, dim, f_group, f_size)
        return _all_reduce(g, mesh, [a for a in axes if a != f_axis])

    def train_step(params, opt_state, batch):
        _require_on(params, dev)
        n_rows = len(next(iter(batch.values())))
        axes = () if mesh is None else _dp_axes(cfg, mesh, n_rows)
        # the leaves whose tokens go over 'model' (raises before any
        # collective where the spec puts 'model' twice)
        toks = _token_split(cfg, mesh, batch) if seq_split else set()
        # the axes the token count, the gradients and the metrics are
        # summed over: the rows' axes, or every axis under a token split
        red = tuple(a for a, n in shape.items() if n > 1) if toks else axes
        f_group = mesh.get_group(f_axis) if f_axis else None
        m_group = mesh.get_group("model") if tensor_parallel else None
        # the dim each leaf is sliced in over the fsdp axis, or None (the
        # placements tree is cut at the params' leaves)
        dims = None if shardings is None or f_axis is None else tree_map(
            lambda _, pl: shard_dim(pl, mesh, f_axis), params, shardings)
        # the leaves that hold this rank's slice over 'model'
        m_dims = None if shardings is None or m_group is None else tree_map(
            lambda _, pl: shard_dim(pl, mesh, "model"), params, shardings)
        if dims is not None and f_size > 1 and f_axis not in red:
            raise ValueError(f"batch {n_rows} does not split over the fsdp "
                             f"axis {f_axis!r} of {f_size}")
        index, count = coordinate(mesh, axes) if axes else (0, 1)
        lo, hi = n_rows // count * index, n_rows // count * (index + 1)
        t_index, t_count = coordinate(mesh, ("model",)) if toks else (0, 1)
        with part.use_mesh(mesh, axes, seq_axis="model" if toks else None):
            with record_function("loss_fwd"):
                b = {}
                for k, v in batch.items():
                    v = torch.as_tensor(v, device=dev)[lo:hi]
                    if k in toks:
                        n = v.shape[1] // t_count
                        v = v[:, n * t_index:n * (t_index + 1)]
                    b[k] = v
                whole = params if dims is None else tree_map(
                    lambda a, d: a if d is None
                    else SH.gather_dim(a, d, f_group, f_size), params, dims)
                p = tree_map(lambda a: a.detach().requires_grad_(True), whole)
                total = (lambda n: _all_reduce(n.clone(), mesh, red)) \
                    if red else None
                loss, metrics = api.loss(
                    p, b, cfg, total=total,
                    aux_weight=1.0 / math.prod(shape[a] for a in red))
            with record_function("backward"):
                loss.backward()
                # a leaf the loss does not reach has a zero gradient, as
                # under jax.grad
                grads = tree_map(lambda a: a.grad if a.grad is not None
                                 else torch.zeros_like(a), p)
                if dims is None:
                    grads = tree_map(lambda g: _all_reduce(g, mesh, red),
                                     grads)
                else:
                    grads = tree_map(lambda g, d: reduce_grad(g, d, red,
                                                              f_group),
                                     grads, dims)
            with record_function("clip"):
                splits = [([d is not None for d in tree_leaves(ds)], group)
                          for ds, group in ((dims, f_group), (m_dims, m_group))
                          if ds is not None]
                gnorm, scale = global_norm_scale(tree_leaves(grads),
                                                 clip_norm, splits=splits)
            with record_function("optimizer"):
                params, opt_state = optimizer.update(grads, opt_state, params,
                                                     grad_scale=scale)
        out = {"loss": loss.detach(), "grad_norm": gnorm}
        out.update({k: v.detach() for k, v in metrics.items()})
        if red:
            # this rank's parts of the loss and its terms -> the global ones
            # ('tokens' is global already)
            keys = [k for k in out if k not in ("grad_norm", "tokens")]
            vals = _all_reduce(torch.stack([out[k] for k in keys]), mesh, red)
            out.update(zip(keys, vals))
        return params, opt_state, out

    if dev.type != "cuda" or not graphs:
        return train_step
    return GraphedStep(train_step, 2, dev, mutates=(0, 1), name="train")


def _dp_axes(cfg: ModelConfig, mesh, batch: int) -> tuple:
    """The axes the batch's rows are split over: the reference's
    ``batch_pspec`` (every axis under ``cfg.pure_dp``, else the batch axes;
    fewer where they do not divide the batch)."""
    entry = SH.batch_pspec(mesh, batch, pure_dp=cfg.pure_dp)[0]
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def _token_split(cfg: ModelConfig, mesh, batch) -> set:
    """The keys of the batch leaves whose tokens the reference's
    ``input_pspec`` puts on 'model'. ValueError ("used twice") where it
    puts 'model' on the rows as well, as the reference refuses the spec."""
    split = set()
    for k, v in batch.items():
        spec = SH.input_pspec(cfg, v, mesh)
        named(mesh, *spec)
        if len(spec) > 1 and spec[1] == "model":
            split.add(k)
    return split


def _all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``x`` in place over the ranks of ``axes``, an axis at a time."""
    for axis in axes:
        dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def _zero3_whole(params, shardings, mesh):
    """``params`` with every leaf that ``shardings`` shard over
    ``fsdp_axis(mesh)`` gathered whole over it (ZeRO-3 at rest -> the
    step's tree); a leaf's slice over 'model' stays this rank's."""
    f_axis = None if mesh is None else fsdp_axis(mesh)
    if shardings is None or f_axis is None:
        return params
    f_size = mesh_shape(mesh)[f_axis]
    group = mesh.get_group(f_axis)
    return tree_map(lambda a, pl: a if shard_dim(pl, mesh, f_axis) is None
                    else SH.gather_dim(a, shard_dim(pl, mesh, f_axis), group,
                                       f_size), params, shardings)


def _rows(mesh, axes, n: int):
    """[lo, hi) of this rank's rows of ``n`` split over ``axes``."""
    index, count = coordinate(mesh, axes) if axes else (0, 1)
    return n // count * index, n // count * (index + 1)


def make_prefill_step(cfg: ModelConfig, device="cuda", graphs: bool = True,
                      mesh=None, shardings=None) -> Callable:
    """Inference prefill: full no-grad forward, last-token logits.

    The returned ``prefill_step(params, batch)`` takes ``batch["inputs"]``
    (B, S) token ids or ``batch["embeds"]`` (B, S, D) (an encoder-decoder:
    ``batch["frames"]`` (B, enc_seq, D) and ``batch["inputs"]``; it encodes
    the frames and runs the decoder over the tokens), as tensors or numpy
    arrays, and returns (B, vocab) float32 logits of the last position on
    ``device``. On a CUDA
    device (unless ``graphs=False``) each (B, S) is captured once and
    replayed; the logits returned are the graph's output, which the next
    call of the same shape overwrites.

    With a ``mesh`` (every family) the step takes the global batch and runs
    this rank's rows over the axes of :func:`_dp_axes`; ``params`` hold this
    rank's slices as ``shardings`` (the params' placements) lay them out:
    the ZeRO-3 leaves are gathered over the fsdp axis before the forward,
    the 'model' slices stay (tensor parallelism, as in training), and the
    logits of this rank's rows come back whole over the vocab."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        _require_on(params, dev)
        n_rows = len(next(iter(batch.values())))
        axes = () if mesh is None else _dp_axes(cfg, mesh, n_rows)
        lo, hi = _rows(mesh, axes, n_rows)
        b = {k: torch.as_tensor(v, device=dev)[lo:hi] for k, v in batch.items()}
        params = _zero3_whole(params, shardings, mesh)
        with part.use_mesh(mesh, axes):
            if cfg.is_encdec:
                enc = encdec.encode(params, b["frames"], cfg)
                h = encdec.decode_train(params, enc, b["inputs"], cfg)
                return transformer.whole_vocab(
                    (h[:, -1] @ params["embed"].T).float(), cfg)
            if "embeds" in b:
                x = b["embeds"].to(transformer._dtype(cfg))
            else:
                x = transformer.embed_tokens(params, b["inputs"], cfg)
            positions = torch.arange(x.shape[1], device=dev)
            h, _ = transformer.forward(params, x, cfg, positions)
            return transformer.whole_vocab(
                transformer.logits_fn(params, h[:, -1:], cfg)[:, 0], cfg)

    if dev.type != "cuda" or not graphs:
        return prefill_step
    return GraphedStep(prefill_step, 1, dev, name="prefill")


def cache_length_axes(cache, cache_shardings, mesh) -> tuple:
    """The mesh axes that ``cache_shardings`` (the placements of ``cache``,
    ``shardings.cache_shardings``) put on the length of the KV caches
    ('k' leaves, (B, Hkv, C, hd)) and of MLA's compressed caches ('c_kv',
    (B, S, r)), in mesh order: () where the length is whole. (The
    recurrent states split a channel dim; their mixers read its axes from
    the leaves' shapes, ``tensor_parallel.split_axes``.)"""
    found = set()

    def one(path, leaf):
        if path[-1] not in ("k", "c_kv"):
            return
        pl = cache_shardings
        for key in path:
            pl = pl[key]
        length_dim = leaf.dim() - 2
        found.update(axis for axis, dim, _ in SH.sharded_axes(pl, mesh)
                     if dim == length_dim)
    SH.map_with_path(one, cache)
    return tuple(a for a in mesh_shape(mesh) if a in found)


def make_decode_step(cfg: ModelConfig, device="cuda", graphs: bool = True,
                     mesh=None, shardings=None,
                     cache_shardings=None) -> Callable:
    """``serve_step(params, cache, tokens, pos) -> (next (B,) int32, logits,
    cache)``; the cache is updated in place. ``pos`` is the absolute
    position, a Python int or a 0-d integer tensor on the device.

    On a CUDA device (unless ``graphs=False``) the step is captured once per
    (params, cache) and batch size: ``tokens`` and ``pos`` are copied into
    the graph's buffers before each replay (the reference's jitted step
    takes them as traced arguments), the cache is written in place (the
    reference donates it), and ``next`` and ``logits`` are the graph's
    outputs, overwritten by the next step.

    With a ``mesh`` the step takes the global ``tokens`` and runs this
    rank's rows over the batch axes of the rules' ``batch_pspec`` (those of
    the caches' rows); ``params`` hold this rank's slices as ``shardings``
    lay them out (ZeRO-3 leaves gathered over the fsdp axis first), and
    ``cache`` this rank's slice as ``cache_shardings`` lay it out: the KV
    heads over 'model', or the length over 'model', or with batch 1 over
    every axis (``layers.attn_decode`` runs each); MLA's latent cache its
    length over 'model', or with batch 1 over ('data', 'model')
    (``layers.mla_decode``); the Mamba, mLSTM and sLSTM states a channel
    dim over 'model', or with batch 1 over every axis (``models.ssm``);
    whisper's cross K/V its rows (``layers.cross_attn_decode``). It
    returns this rank's rows: the greedy tokens and the logits whole over
    the vocab. A step moves a token's activations between the ranks,
    never a cache leaf or a whole weight (at batch 1 a recurrent state's
    chunk takes its rows of the per-channel weights from the rank that
    holds them: ``tensor_parallel.rows_for``)."""
    dev = resolve_device(device)
    api = model_api(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        _require_on(params, dev)
        tokens = torch.as_tensor(tokens, device=dev)
        if mesh is None:
            logits, cache = api.decode_step(params, cache, tokens, pos, cfg)
            return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache
        entry = SH.batch_pspec(mesh, len(tokens), 0)[0]
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else tuple(entry)
        lo, hi = _rows(mesh, axes, len(tokens))
        length_axes = () if cache_shardings is None else \
            cache_length_axes(cache, cache_shardings, mesh)
        params = _zero3_whole(params, shardings, mesh)
        with part.use_mesh(mesh, axes, cache_axes=length_axes):
            logits, cache = api.decode_step(params, cache, tokens[lo:hi], pos,
                                            cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    if dev.type != "cuda" or not graphs:
        return serve_step
    return GraphedStep(serve_step, 2, dev, mutates=(1,), name="decode")
