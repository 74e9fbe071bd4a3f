"""Sharding rules: parameters, optimizer state, inputs and caches, and the
ZeRO-3 layout that the train step and the checkpoints hold at rest.

Counterpart of the reference's ``launch/shardings.py``, with its path- and
block-type rules (the same leaf name 'wq' is an output-sharded head
projection in attention but an input-sharded d_inner matrix in mLSTM):

* tensor parallelism over ``model``: attention heads, MoE experts, FFN
  hidden, SSM inner;
* FSDP (ZeRO-3) over ``data`` for parameters and optimizer state when
  ``fsdp=True``: the non-TP dim of each large matrix;
* the batch over ``pod`` x ``data`` (every axis under ``cfg.pure_dp``);
* decode caches: batch-sharded when divisible; KV heads over ``model`` when
  divisible, else the cache length over ``model``; batch 1 shards the
  length or state over every axis available.

The ``*_pspec`` functions return a spec tuple with the entries of the
reference's ``PartitionSpec``: None, an axis name, or a tuple of two or more
axis names (a one-axis tuple is the name, as ``PartitionSpec`` writes it).
They read the mesh's axis names and sizes only (``layout.mesh_shape``),
so a ``{axis: size}`` mapping stands in for a mesh. The ``*_shardings``
functions return trees of DTensor placements (``layout.named``). Paths
are the port's dict keys and list indices, which are the reference's tree
paths (``weights.from_jax_params`` is a checked tree map).

What the port runs of them (``launch.steps``): data parallelism over the
batch axes, and ZeRO-3 over ``fsdp_axis``, where :func:`shard_tree` holds
each leaf that the rules shard over it as this rank's slice of the leaf's
dim, and :func:`gather_dim` / :func:`scatter_dim` (from
:mod:`repro_torch.collectives`) move whole tensors and slices between the
ranks.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.collectives import gather_dim, scatter_dim  # noqa: F401
from repro_torch.layout import (axis_names, local_shard, mesh_shape, named,
                                sharded_axes)
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_map
from .mesh import batch_axes, fsdp_axis

NORMS = {"ln1", "ln2", "ln_x", "final_norm", "enc_norm", "norm", "q_norm",
         "kv_norm", "norm_h", "norm_e"}
REPLICATED = NORMS | {"b", "gate_bias", "dt_bias", "router", "w_gates",
                      "enc_pos", "dec_pos", "r", "wkr"}
ATTN_QKV = {"wq", "wk", "wv", "wuq", "wukv", "wdq", "wdkv"}


def map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` for every leaf of nested dicts, lists and tuples;
    a path holds dict keys and sequence indices (ints)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _names(path) -> list:
    return [f"[{k}]" if isinstance(k, int) else str(k) for k in path]


def _entry(ax):
    """A spec entry as ``PartitionSpec`` writes it: a one-axis tuple is the
    axis's name."""
    if isinstance(ax, tuple) and len(ax) == 1:
        return ax[0]
    return ax


def _mixer_of(names, cfg: ModelConfig) -> Optional[str]:
    if any(n in ("self", "cross", "attn") for n in names):
        return "attn"
    if "mixer" in names:
        pos = [n for n in names if n.startswith("pos")]
        if pos:
            return cfg.period[int(pos[0][3:])][0]
        return cfg.period[0][0]          # prefix / mtp block
    return None


def _divisible(mesh, axis, size: int) -> bool:
    if axis is None:
        return True
    axes = (axis,) if isinstance(axis, str) else axis
    shape = mesh_shape(mesh)
    return size % math.prod(shape[a] for a in axes) == 0


def _guard(spec: Tuple, shape, mesh) -> tuple:
    """Drop axes that don't divide the corresponding dim."""
    return tuple(_entry(ax) if ax is not None and _divisible(mesh, ax, dim)
                 else None for dim, ax in zip(shape, spec))


def param_pspec(path, leaf, cfg: ModelConfig, mesh, fsdp: bool) -> tuple:
    if cfg.pure_dp:
        return (None,) * leaf.ndim
    names = _names(path)
    n = names[-1]
    f = fsdp_axis(mesh) if fsdp else None
    stacked = any(x in names for x in ("stack", "encoder", "decoder"))
    core = leaf.ndim - (1 if stacked else 0)

    def out(*spec):
        spec = (None,) * (core - len(spec)) + spec if len(spec) < core else spec
        full = ((None,) if stacked else ()) + tuple(spec)
        return _guard(full, leaf.shape, mesh)

    if n in REPLICATED or core == 0:
        # SSM per-channel vectors still shard over model when sized d_inner
        if n in ("A_log",):
            return out("model", None)
        if n in ("D",) and core == 1:
            return out("model")
        return out(*([None] * core))
    if n == "embed":
        return out("model", f)
    if n == "head":
        return out(f, "model")
    if n == "proj" and "mtp" in names:
        return out(f, "model")
    if "experts" in names:
        if n in ("gate", "up"):
            return out("model", f, None)
        if n == "down":
            return out("model", None, f)
    mixer = _mixer_of(names, cfg)
    if n in ATTN_QKV and mixer in ("attn", "mla", None):
        return out(f, "model")
    if n == "wo":
        return out("model", f)
    if n in ("gate", "up"):                      # dense MLP / shared expert
        return out(f, "model")
    if n == "down":
        return out("model", f)
    if mixer == "mamba":
        table = {"in_proj": (f, "model"), "conv": ("model", None),
                 "x_proj": ("model", None), "dt_proj": (None, "model"),
                 "A_log": ("model", None), "D": ("model",),
                 "out_proj": ("model", f)}
        if n in table:
            return out(*table[n])
    if mixer == "mlstm":
        table = {"in_proj": (f, "model"), "conv": ("model", None),
                 "wq": ("model", None), "wk": ("model", None),
                 "wv": ("model", None), "out_proj": ("model", f)}
        if n in table:
            return out(*table[n])
    if mixer == "slstm":
        table = {"w": (f, "model"), "out_proj": ("model", f)}
        if n in table:
            return out(*table[n])
    if n in ("wq", "wk", "wv"):                  # whisper enc/dec attention
        return out(f, "model")
    return out(*([None] * core))


def param_shardings(cfg: ModelConfig, tree, mesh, fsdp: bool):
    """Tree of DTensor placements matching ``tree`` (params, or anything
    with their shapes)."""
    return map_with_path(
        lambda path, leaf: named(mesh, *param_pspec(path, leaf, cfg, mesh,
                                                    fsdp)), tree)


# --------------------------------------------------------------------------
# Inputs and caches
# --------------------------------------------------------------------------

def batch_pspec(mesh, batch: int, extra_dims: int = 1,
                pure_dp: bool = False) -> tuple:
    ba = axis_names(mesh) if pure_dp else batch_axes(mesh)
    if not _divisible(mesh, ba, batch):
        ba = batch_axes(mesh)
        if not _divisible(mesh, ba, batch):
            ba = None
    return (_entry(ba),) + (None,) * extra_dims


def input_pspec(cfg: ModelConfig, leaf, mesh) -> tuple:
    """The spec of one leaf of a train batch (leading dim the batch)."""
    spec = batch_pspec(mesh, leaf.shape[0], leaf.ndim - 1,
                       pure_dp=cfg.pure_dp)
    if cfg.seq_shard and leaf.ndim >= 2 and \
            _divisible(mesh, "model", leaf.shape[1]):
        # context parallelism: tokens sharded over 'model'
        spec = (spec[0], "model") + (None,) * (leaf.ndim - 2)
    return spec


def input_shardings(cfg: ModelConfig, batch_tree, mesh):
    """Placements for a train batch (tensors, or anything with their
    shapes)."""
    return map_with_path(
        lambda path, leaf: named(mesh, *input_pspec(cfg, leaf, mesh)),
        batch_tree)


def cache_pspec(path, leaf, cfg: ModelConfig, mesh) -> tuple:
    names = _names(path)
    n = names[-1]
    # 'stack' (decoder-only) and encdec 'self'/'cross' carry a leading L dim
    stacked = "stack" in names or ("self" in names or "cross" in names)
    lead = (None,) if stacked else ()
    core_shape = leaf.shape[1:] if stacked else leaf.shape
    b = core_shape[0]
    ba = batch_axes(mesh)
    shape = mesh_shape(mesh)
    all_axes = axis_names(mesh)
    b_ok = _divisible(mesh, ba, b) and b >= math.prod(shape[a] for a in ba)

    def guard(*spec):
        return _guard(lead + spec, leaf.shape, mesh)

    if n in ("k", "v"):                          # (B, Hkv, C, hd)
        hkv, c = core_shape[1], core_shape[2]
        if b_ok:
            if _divisible(mesh, "model", hkv):
                return guard(ba, "model", None, None)
            return guard(ba, None, "model", None)
        # batch-1 long context: shard the cache length over everything
        if _divisible(mesh, all_axes, c):
            return guard(None, None, all_axes, None)
        return guard(None, None, ("data", "model"), None)
    if n in ("c_kv", "k_rope"):                  # MLA (B, S, r)
        if b_ok:
            return guard(ba, "model", None)
        return guard(None, ("data", "model"), None)
    if n == "conv":                              # (B, K-1, di)
        if b_ok:
            return guard(ba, None, "model")
        return guard(None, None, all_axes)
    if n == "h" and len(core_shape) == 3:        # mamba (B, di, N)
        if b_ok:
            return guard(ba, "model", None)
        return guard(None, all_axes, None)
    if n == "h" and len(core_shape) == 2:        # slstm (B, D)
        if b_ok:
            return guard(ba, "model")
        return guard(None, all_axes)
    if n == "C":                                 # mLSTM (B, H, dk, dv)
        if b_ok:
            return guard(ba, None, None, "model")
        return guard(None, None, None, "model")
    if n in ("n", "m"):                          # mLSTM (B, H, dk) | slstm
        if b_ok:
            return guard(*((ba,) + (None,) * (len(core_shape) - 1)))
        return guard(*((None,) * len(core_shape)))
    if n in ("c",):                              # slstm scalars (B, D)
        if b_ok:
            return guard(ba, "model")
        return guard(None, all_axes)
    # whisper cross kv tuple leaves: (L, B, Hkv, S_enc, hd)
    if leaf.ndim == 5:
        return _guard((None, ba if b_ok else None, None, None, None),
                      leaf.shape, mesh)
    if b_ok:
        return guard(*((ba,) + (None,) * (len(core_shape) - 1)))
    return guard(*((None,) * len(core_shape)))


def cache_shardings(cfg: ModelConfig, cache_tree, mesh):
    return map_with_path(
        lambda path, leaf: named(mesh, *cache_pspec(path, leaf, cfg, mesh)),
        cache_tree)


# --------------------------------------------------------------------------
# Slices at rest, whole tensors in the step
# --------------------------------------------------------------------------

def shard_tree(tree, shardings, mesh):
    """Every leaf of ``tree`` (whole tensors) as this rank's slice."""
    return tree_map(lambda t, pl: local_shard(t, pl, mesh)
                    if isinstance(t, torch.Tensor) and pl is not None else t,
                    tree, shardings)


def gather_tree(tree, shardings, mesh):
    """Every leaf of ``tree`` (this rank's slices) whole, gathered from
    every rank; every rank must call it. The last axis to split a dim is
    undone first."""

    def one(t, pl):
        if not isinstance(t, torch.Tensor) or pl is None:
            return t
        for axis, dim, n in reversed(sharded_axes(pl, mesh)):
            t = gather_dim(t, dim, mesh.get_group(axis), n)
        return t
    return tree_map(one, tree, shardings)

