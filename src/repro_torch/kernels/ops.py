"""Public kernel entry points used by the model code.

Counterpart of :mod:`repro.kernels.ops`, without its ``impl=`` switch: the
tensors' device picks the path. A CUDA tensor runs the hand-written kernel
(or raises), a CPU tensor runs the plain version from :mod:`.ref`. The tile
sizes belong to the kernels, so ``q_chunk``/``kv_chunk`` are not taken.

  rmsnorm(x, scale, eps=1e-6)
  flash_attention(q, k, v, causal=True, window=None, offset=0, scale=None)
      q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D); ``offset``
      is the absolute position of q[0] relative to kv[0].
  cp_flash_attention(q, k, v, mesh, axis="model", causal=True, window=None,
                     scale=None)
      ring context-parallel attention: q/k/v are this rank's (B, H, L, D)
      shard of a sequence split over the mesh axis ``axis`` in rank order;
      -> this rank's (B, Hq, L, D) rows of causal attention over the whole
      sequence. Each rank pulls the K/V of the r shards before its own
      (``collectives.ring_pull``; r = n - 1, or ceil(window / L) with a
      window) and runs ``flash_attention`` on them with ``offset`` placing
      its rows; the pulled slices' gradients go home (``ring_push``).
  decode_attention(q, k, v, length=None, window=None, scale=None)
      q: (B, Hq, D); k/v: (B, Hkv, S, D); length: (B,) int32 -> (B, Hq, D).
  mamba_scan(u, dt, A, B, C, D, h0=None)
      u/dt: (Bt, T, d_in); A: (d_in, N); B/C: (Bt, T, N); D: (d_in,);
      h0: (Bt, d_in, N) -> (y (Bt, T, d_in), h_T (Bt, d_in, N) float32).
  mamba_step(u, dt, A, B, C, D, h)
      one decode step, plain PyTorch on every device (the reference has no
      kernel for it either).
"""
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.layout import mesh_shape
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .rmsnorm import rmsnorm


class _RingKV(torch.autograd.Function):
    """k, v (B, Hkv, L, D) -> the K/V of this rank's pulled shards then its
    own, concatenated along S (one contiguous buffer; k and v move as one
    message). The backward sends the pulled slices' gradients to their
    ranks and adds what this rank's successors send it to its own, in
    float32."""

    @staticmethod
    def forward(ctx, k, v, r, group):
        kv = torch.stack((k, v))
        kvg = torch.cat(collectives.ring_pull(kv, r, group) + [kv], dim=3)
        ctx.r, ctx.group, ctx.length = r, group, k.shape[2]
        return kvg[0], kvg[1]

    @staticmethod
    def backward(ctx, dkg, dvg):
        length = ctx.length
        dkv = torch.stack((dkg, dvg))
        pulled = dkv.shape[3] // length - 1
        parts = [dkv[:, :, :, j * length:(j + 1) * length].contiguous()
                 for j in range(pulled)]
        own = dkv[:, :, :, pulled * length:]
        pushed = collectives.ring_push(parts, ctx.r, ctx.group, like=own)
        own = (own.float() + pushed).to(own.dtype)
        return own[0], own[1], None, None


def cp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh, axis: str = "model", causal: bool = True,
                       window: Optional[int] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Ring context-parallel attention (the reference's ``shard_map`` ring
    gather). q: (B, Hq, L, D), k/v: (B, Hkv, L, D), this rank's contiguous
    shard of a sequence of n L positions split over ``axis`` of ``mesh`` (a
    ``DeviceMesh``) in rank order -> (B, Hq, L, D).

    Rank ``idx`` pulls the K/V of ranks ``idx - r' .. idx - 1``, r' =
    min(idx, r), r = n - 1 or min(n - 1, ceil(window / L)), and runs
    :func:`flash_attention` on them and its own, its q row 0 at ``offset``
    r' L. The reference pulls r shards on every rank, zeros on the first
    ranks, and masks them with a lower bound on the key positions; pulling
    only the shards that exist is the same function with no masked
    columns. Every row sees its own key, so none is empty. With no mesh,
    or ``axis`` of size 1: :func:`flash_attention` on q, k, v, with no
    collective. ``causal=False`` raises ValueError: the reference accepts
    it but then attends only to the shards before a rank's own."""
    if not causal:
        raise ValueError("cp_flash_attention: the ring attends causally; "
                         "causal=False is not defined over a split sequence")
    n = 1 if mesh is None else mesh_shape(mesh).get(axis, 1)
    if n == 1:
        return flash_attention(q, k, v, causal=True, window=window,
                               scale=scale)
    length = q.shape[2]
    if k.shape[2] != length:
        raise ValueError(f"cp_flash_attention: q's shard of {length} positions"
                         f" and k's of {k.shape[2]} differ")
    r = n - 1 if window is None else min(n - 1, -(-window // length))
    group = mesh.get_group(axis)
    pulled = min(dist.get_rank(group), r)
    kg, vg = _RingKV.apply(k, v, r, group)
    return flash_attention(q, kg, vg, causal=True, window=window,
                           offset=pulled * length, scale=scale)


def mamba_step(u, dt, A, B, C, D, h):
    """Single decode step: u/dt (Bt, d_in); B/C (Bt, N); h (Bt, d_in, N)."""
    da = torch.exp(dt.float()[..., None] * A.float())
    db = dt.float()[..., None] * B.float()[:, None, :]
    h = da * h + db * u.float()[..., None]
    y = torch.einsum("bdn,bn->bd", h, C.float()) + D.float() * u.float()
    return y.to(u.dtype), h


__all__ = ["rmsnorm", "flash_attention", "cp_flash_attention",
           "decode_attention", "mamba_scan", "mamba_step"]
