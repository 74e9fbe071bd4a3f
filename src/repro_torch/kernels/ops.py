"""Public kernel entry points used by the model code.

Counterpart of :mod:`repro.kernels.ops`, without its ``impl=`` switch: the
tensors' device picks the path. A CUDA tensor runs the hand-written kernel
(or raises), a CPU tensor runs the plain version from :mod:`.ref`. The tile
sizes belong to the kernels, so ``q_chunk``/``kv_chunk`` are not taken.
``cp_flash_attention``, ``mamba_scan`` and ``mamba_step`` come with later
slices (ROADMAP.md).

  rmsnorm(x, scale, eps=1e-6)
  flash_attention(q, k, v, causal=True, window=None, offset=0, scale=None)
      q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D); ``offset``
      is the absolute position of q[0] relative to kv[0].
  decode_attention(q, k, v, length=None, window=None, scale=None)
      q: (B, Hq, D); k/v: (B, Hkv, S, D); length: (B,) int32 -> (B, Hq, D).
"""
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .rmsnorm import rmsnorm

__all__ = ["rmsnorm", "flash_attention", "decode_attention"]
