"""Fused RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Counterpart of :mod:`repro.kernels.rmsnorm` (``rmsnorm_pallas``). A CUDA
tensor goes to the kernel, one read and one write of x; a CPU tensor goes to
the plain version, :func:`rmsnorm_plain`.
"""
from __future__ import annotations

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda
from .ref import rmsnorm_ref as rmsnorm_plain

MAX_D = 8192


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel: x (..., d) bf16 or f32, scale (d,) f32 -> x's
    dtype. Raises on anything the kernel does not take."""
    require_cuda("rmsnorm", x, scale)
    d = x.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm: x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale must be float32 of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not (0 < d <= MAX_D):
        raise ValueError(f"rmsnorm: d={d} outside 1..{MAX_D}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    lib = _build.load()
    _build.check(lib.rmsnorm_fwd(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                 rows, d, float(eps), DTYPE_CODES[x.dtype],
                                 _build.stream_handle(x)), "rmsnorm_fwd")
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)
