"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# head dims each attention kernel is instantiated for, by dtype: 16 and 20
# are the SMOKE configs', 24 and 192 MLA's qk width (DeepSeek SMOKE and
# full); a bf16 row of 20 (40 bytes) is no whole number of the 16-byte loads
# and TMA rows the bf16 kernels read. Each kernel has its own set, so that
# widening one claims nothing for the others.
_DENSE = {torch.float32: (16, 20, 32, 64, 80, 128),
          torch.bfloat16: (16, 32, 64, 80, 128)}
HEAD_DIMS = {
    "flash_attention": {torch.float32: (16, 20, 24, 32, 64, 80, 128, 192),
                        torch.bfloat16: (16, 32, 64, 80, 128, 192)},
    "flash_attention_bwd": {torch.float32: (16, 20, 24, 32, 64, 80, 128, 192),
                            torch.bfloat16: (16, 32, 64, 80, 128, 192)},
    "decode_attention": _DENSE,
}
# where the missing head dims of each kernel stand in ROADMAP.md
_LATER = {
    "flash_attention": "queue 2, K1",
    "flash_attention_bwd": "queue 2, K1 (the flash kernels' other head dims)",
    "decode_attention": "queue 2, K2",
}


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")


def require_head_dim(name: str, d: int, dtype: torch.dtype) -> None:
    """Raise NotImplementedError unless kernel ``name`` (a key of
    ``HEAD_DIMS``) has an instance for head dim ``d`` in ``dtype``."""
    have = HEAD_DIMS[name][dtype]
    if d not in have:
        raise NotImplementedError(
            f"{name}: head dim {d} has no {dtype} kernel instance (have "
            f"{have}); see ROADMAP.md, {_LATER[name]}")


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward, rather than return an output cut off from the graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward (it serves decoding, as "
            "the reference's does)")
