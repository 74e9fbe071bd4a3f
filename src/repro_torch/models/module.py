"""Minimal functional parameter utilities.

Counterpart of :mod:`repro.models.module`. Parameters are nested dicts of
tensors. Layer stacks hold *stacked* parameters (leading axis = repeat
count), the layout the reference scans over; the port loops over that axis.
Weights are drawn in float32 from an explicit ``torch.Generator`` and then
cast, with the reference's scales.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

Params = Dict[str, Any]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of nested dicts/lists, and to the matching
    parts of the trees in ``rest`` (which have ``tree``'s structure down to
    its leaves; below them they are passed whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    # A meta target draws nothing; otherwise draw where the generator lives.
    dev = device if torch.device(device).type == "meta" else gen.device
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)


# a draw of more elements than this is made in slices of the leading axis,
# so that its float32 copy stays under 1 GiB (DeepSeek-V3's expert stacks
# hold 3.8 G elements a leaf)
_DRAW_SLICE = 2 ** 28
_DRAW_LIMIT = 2 ** 31


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """Standard normal draws of ``shape`` times ``scale``, cast to dtype.
    Above ``_DRAW_LIMIT`` elements the leading axis is drawn a slice at a
    time into the result."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n <= _DRAW_LIMIT or torch.device(device).type == "meta":
        return (_normal(gen, shape, device) * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, _DRAW_SLICE // (n // shape[0]))
    for i in range(0, shape[0], rows):
        part = out[i:i + rows]
        part.copy_(_normal(gen, part.shape, device) * scale)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float = None, dtype=torch.bfloat16,
               device="cpu") -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return normal_init(gen, (d_in, d_out), scale, dtype, device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16,
               device="cpu") -> torch.Tensor:
    return normal_init(gen, (vocab, d), 0.02, dtype, device)


def stack_init(init_fn: Callable[[torch.Generator], Params],
               gen: torch.Generator, n: int) -> Params:
    """Stack n independent inits along a new leading axis. Each init is
    copied into its slot of the stacked tree and dropped before the next,
    so the peak is the stack plus one layer."""
    first = init_fn(gen)
    stacked = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    tree_map(lambda s, a: s[0].copy_(a), stacked, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, a, i=i: s[i].copy_(a), stacked, init_fn(gen))
    return stacked


def param_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
