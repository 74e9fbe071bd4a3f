"""Fused RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu`` (forward) and
``csrc/rmsnorm_bwd.cu`` (backward), and their plain versions.

Counterpart of :mod:`repro.kernels.rmsnorm` (``rmsnorm_pallas``). A CUDA
tensor goes to the kernel, one read and one write of x; a CPU tensor goes to
the plain version, :func:`rmsnorm_plain`, which autograd differentiates.
Where autograd needs a gradient of a CUDA call, :class:`_RMSNorm` runs the
forward kernel and, for the backward, :func:`rmsnorm_bwd_cuda`, whose plain
version is :func:`rmsnorm_bwd_plain`.
"""
from __future__ import annotations

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda
from .ref import rmsnorm_bwd_ref as rmsnorm_bwd_plain
from .ref import rmsnorm_ref as rmsnorm_plain

MAX_D = 8192
# the backward's first launch (csrc/rmsnorm_bwd.cu) runs at most this many
# blocks per SM, each writing one row of dscale partial sums
BWD_BLOCKS_PER_SM = 2


def _check(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    require_cuda(name, x, scale)
    d = x.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"{name}: scale must be float32 of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not (0 < d <= MAX_D):
        raise ValueError(f"{name}: d={d} outside 1..{MAX_D}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: x and scale must be contiguous")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel: x (..., d) bf16 or f32, scale (d,) f32 -> x's
    dtype. Raises on anything the kernel does not take."""
    _check("rmsnorm", x, scale)
    d = x.shape[-1]
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


def bwd_partial_rows(rows: int, n_sm: int) -> int:
    """Rows of the backward's dscale workspace: the most blocks its first
    launch may run (the kernel takes at most this many, and fewer where an
    instance keeps fewer resident or a pass needs fewer)."""
    return max(1, min(rows, BWD_BLOCKS_PER_SM * n_sm))


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """Launch the backward kernel: x, dy (..., d) in x's dtype (dy is made
    contiguous if it is not), scale (d,) f32 -> (dx in x's dtype, dscale
    (d,) float32)."""
    _check("rmsnorm_bwd", x, scale)
    require_cuda("rmsnorm_bwd", x, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {dy.dtype} {tuple(dy.shape)} does not "
                         f"match x {x.dtype} {tuple(x.shape)}")
    dy = dy.contiguous()
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    n_sm = _build.sm_count(x.device.index)
    max_blocks = bwd_partial_rows(rows, n_sm)
    partial = torch.empty((max_blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    lib = _build.load()
    _build.check(lib.rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), rows, d, max_blocks, n_sm,
        float(eps), DTYPE_CODES[x.dtype], _build.stream_handle(x)), "rmsnorm_bwd")
    rmsnorm_bwd_cuda.launches += 1
    return dx, dscale


rmsnorm_bwd_cuda.launches = 0


class _RMSNorm(torch.autograd.Function):
    """The forward kernel, and the backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The kernel for a CUDA tensor (through :class:`_RMSNorm` when autograd
    needs its gradient), the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)
