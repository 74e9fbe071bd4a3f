"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# head dims the attention kernels are instantiated for
HEAD_DIMS = (32, 64, 80, 128)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")


def require_head_dim(name: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: head dim {d} has no kernel instance (have {HEAD_DIMS}); "
            "other head dims come with the MoE/MLA slice (ROADMAP.md, queue 1, "
            "item 3)")
