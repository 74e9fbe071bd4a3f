"""Public kernel entry points used by the model code.

Counterpart of :mod:`repro.kernels.ops`, without its ``impl=`` switch: the
tensors' device picks the path. A CUDA tensor runs the hand-written kernel
(or raises), a CPU tensor runs the plain version from :mod:`.ref`. The tile
sizes belong to the kernels, so ``q_chunk``/``kv_chunk`` are not taken.
``cp_flash_attention`` comes with the distributed slice (ROADMAP.md).

  rmsnorm(x, scale, eps=1e-6)
  flash_attention(q, k, v, causal=True, window=None, offset=0, scale=None)
      q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D); ``offset``
      is the absolute position of q[0] relative to kv[0].
  decode_attention(q, k, v, length=None, window=None, scale=None)
      q: (B, Hq, D); k/v: (B, Hkv, S, D); length: (B,) int32 -> (B, Hq, D).
  mamba_scan(u, dt, A, B, C, D, h0=None)
      u/dt: (Bt, T, d_in); A: (d_in, N); B/C: (Bt, T, N); D: (d_in,);
      h0: (Bt, d_in, N) -> (y (Bt, T, d_in), h_T (Bt, d_in, N) float32).
  mamba_step(u, dt, A, B, C, D, h)
      one decode step, plain PyTorch on every device (the reference has no
      kernel for it either).
"""
import torch

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .rmsnorm import rmsnorm


def mamba_step(u, dt, A, B, C, D, h):
    """Single decode step: u/dt (Bt, d_in); B/C (Bt, N); h (Bt, d_in, N)."""
    da = torch.exp(dt.float()[..., None] * A.float())
    db = dt.float()[..., None] * B.float()[:, None, :]
    h = da * h + db * u.float()[..., None]
    y = torch.einsum("bdn,bn->bd", h, C.float()) + D.float() * u.float()
    return y.to(u.dtype), h


__all__ = ["rmsnorm", "flash_attention", "decode_attention", "mamba_scan",
           "mamba_step"]
