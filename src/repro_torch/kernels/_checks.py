"""Argument checks shared by the kernel wrappers, and the route a call
takes.

Each kernel entry (``ops.*``) runs its plain version on a real CPU tensor
(:func:`plain`), and otherwise calls its operator, a ``torch.library``
custom op of the ``repro_torch`` namespace: on a CUDA tensor the kernel, on
a fake or meta tensor (``FakeTensorMode``, the dry-run) its shape-only
version, which materialises nothing, and under :func:`operators_on_cpu` on
a real CPU tensor the plain version behind the operator (the attention,
RMSNorm and optimizer operators; the scan's have none), so that a
dispatch mode (``FlopCounterMode``) sees the same operators on the CPU as
on fakes.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

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


_ROUTE = {"operators_on_cpu": False}


def plain(name: str, t: torch.Tensor) -> bool:
    """Whether a call of kernel ``name`` on ``t`` takes the plain version
    directly (a real CPU tensor, outside :func:`operators_on_cpu`) or its
    operator (a CUDA or fake tensor, or a CPU one inside). Any other tensor
    (a meta one) raises ValueError: it has no kernel and no plain version."""
    if isinstance(t, FakeTensor):
        return False
    kind = t.device.type
    if kind == "cpu":
        return not _ROUTE["operators_on_cpu"]
    if kind != "cuda":
        raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                         f"device, got {t.device}")
    return False


@contextlib.contextmanager
def operators_on_cpu():
    """Real CPU tensors go through the kernels' operators too (each runs its
    plain version there), as CUDA and fake tensors do."""
    prev = _ROUTE["operators_on_cpu"]
    _ROUTE["operators_on_cpu"] = True
    try:
        yield
    finally:
        _ROUTE["operators_on_cpu"] = prev


# the H100's SMs: the launch plans of a kernel whose operator runs on a fake
# tensor (the dry-run plans rank 0's program for the card)
H100_SMS = 132


def visible_pairs(sq: int, skv: int, causal: bool, window: Optional[int],
                  offset: int) -> int:
    """(query, key) pairs an attention of ``sq`` rows against ``skv`` keys
    computes, row i at absolute position i + offset: keys j <= i + offset
    when causal, j > i + offset - window with a window (``ref._mask``)."""
    a = np.arange(offset, offset + sq, dtype=np.int64)
    hi = np.minimum(a, skv - 1) if causal else np.full_like(a, skv - 1)
    lo = np.maximum(a - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())
