"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# head dims the attention kernels are instantiated for, by dtype: 16 and 20
# are the SMOKE configs'; a bf16 row of 20 (40 bytes) is no whole number of
# the 16-byte loads and TMA rows the bf16 kernels read
HEAD_DIMS = {torch.float32: (16, 20, 32, 64, 80, 128),
             torch.bfloat16: (16, 32, 64, 80, 128)}


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")


def require_head_dim(name: str, d: int, dtype: torch.dtype) -> None:
    have = HEAD_DIMS[dtype]
    if d not in have:
        raise NotImplementedError(
            f"{name}: head dim {d} has no {dtype} kernel instance (have "
            f"{have}); other head dims come with the MoE/MLA slice (ROADMAP.md,"
            " queue 1, item 3)")


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward, rather than return an output cut off from the graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward; its gradient comes with"
            " a later slice (ROADMAP.md, queue 2)")
