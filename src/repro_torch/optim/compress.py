"""Gradient compression for the slow (cross-pod) axis.

Counterpart of the reference's ``optim/compress.py``: int8 quantization with
one scale per bucket and stochastic rounding (unbiased: E[dequant(quant(g))]
= g), and the *jumbo-tuple* bucket, every leaf in one flat float32 buffer,
so the cross-pod exchange is one large transfer instead of hundreds of
small ones (paper §5.2).

Exchange (:func:`cross_pod_allreduce_int8`): each rank quantizes its bucket,
all-gathers the int8 buffer and the float32 scales over the mesh's 'pod'
group (int8 on the wire: a quarter of float32's bytes), dequantizes every
pod's buffer and takes their mean. The reference hands one replicated key
to every shard, so every pod draws the same noise; here every rank draws
from a generator seeded alike. On a mesh without a 'pod' axis it returns
the gradients as they are. No train step calls it (nor does the
reference's).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.layout import axis_names, mesh_shape
from repro_torch.models.module import tree_leaves

_LEVELS = 127.0


def _quantize(x: torch.Tensor, noise: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (q int8, scale 0-d float32), ``noise`` (x's shape, float32,
    in [-0.5, 0.5)) added before rounding, or none. A test passes the
    reference's own ``jax.random.uniform(key) - 0.5`` here."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / _LEVELS
    y = x32 / scale
    if noise is not None:
        y = y + noise
    # round half to even, as jnp.round
    q = torch.clamp(torch.round(y), -_LEVELS, _LEVELS).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  stochastic: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q, scale) with scale =
    max(max|x|, 1e-12) / 127 over the whole tensor. With ``stochastic`` a
    uniform draw in [-0.5, 0.5) from ``generator`` (on x's device) is added
    before rounding."""
    noise = None
    if stochastic:
        if generator is None:
            raise ValueError("quantize_int8: stochastic rounding takes a "
                             "torch.Generator")
        noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                           device=x.device) - 0.5
    return _quantize(x, noise)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def flatten_bucket(tree: Any) -> Tuple[torch.Tensor, Any]:
    """Jumbo-tuple bucketing: every leaf (``tree_leaves`` order) in one
    float32 buffer, and what :func:`unflatten_bucket` needs to rebuild the
    tree (each leaf's shape and dtype)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([t.float().reshape(-1) for t in leaves])
    return flat, (tree, [(tuple(t.shape), t.dtype) for t in leaves])


def unflatten_bucket(flat: torch.Tensor, meta) -> Any:
    """The tree of :func:`flatten_bucket` from ``flat``, each leaf in its
    own dtype."""
    tree, shapes = meta
    it = iter(shapes)
    pos = [0]

    def build(node):
        if isinstance(node, dict):      # leaves in sorted-key order
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        shape, dtype = next(it)
        n = 1
        for d in shape:
            n *= d
        out = flat[pos[0]:pos[0] + n].reshape(shape).to(dtype)
        pos[0] += n
        return out

    return build(tree)


def cross_pod_allreduce_int8(grads: Any, mesh, generator: torch.Generator,
                             pod_axis: str = "pod") -> Any:
    """The mean over the ``pod_axis`` group of every pod's ``grads`` (a tree
    of tensors), exchanged as int8: quantize the flat bucket (stochastic,
    from ``generator``, which every rank seeds alike), all-gather the int8
    buffer and the scales over the group, dequantize each pod's and take
    the mean. Returns a new tree, each leaf in its dtype; ``grads`` itself
    where the mesh has no ``pod_axis``. Every rank of the group must call
    it."""
    if mesh is None or pod_axis not in axis_names(mesh):
        return grads
    flat, meta = flatten_bucket(grads)
    n = mesh_shape(mesh)[pod_axis]
    group = mesh.get_group(pod_axis)
    q, scale = quantize_int8(flat, generator)
    qs = collectives.all_gather(q.new_empty((n, q.numel())), q, group)
    ss = scale.new_empty((n,))
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    deq = (qs.float() * ss[:, None]).mean(dim=0)
    return unflatten_bucket(deq, meta)
