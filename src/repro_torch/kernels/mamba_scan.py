"""Selective scan (Mamba): the CUDA kernel ``csrc/mamba_scan.cu`` and its
plain version.

Counterpart of :mod:`repro.kernels.mamba_scan` (``mamba_scan_pallas``): the
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t, y_t = C_t . h_t + D u_t
from ``h0`` (zeros when None), with float32 state. A CUDA tensor goes to the
kernel, a CPU tensor to :func:`mamba_scan_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda, require_no_grad
from .ref import mamba_scan_ref as mamba_scan_plain

MAX_N = 16
# The kernel's launch plan (csrc/mamba_scan.cu): blocks of this many
# channels of one batch row, sized for this many resident blocks per SM.
CHANNELS_PER_BLOCK = 128
BLOCKS_PER_SM = 4


def blocks_per_sm(n: int, dtype: torch.dtype) -> int:
    """Blocks of the scan instance for state width ``n`` and u's ``dtype``
    that one SM of the current card holds at once (CUDA's occupancy
    calculator); the plan is sized for at least BLOCKS_PER_SM."""
    if dtype not in DTYPE_CODES or not 1 <= n <= MAX_N:
        raise ValueError(f"mamba_scan: no instance for n={n}, {dtype}")
    blocks = _build.load().mamba_scan_blocks_per_sm(n, DTYPE_CODES[dtype])
    if blocks < 0:
        raise RuntimeError("mamba_scan: the occupancy query failed")
    return blocks


def mamba_scan_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    h0: Optional[torch.Tensor] = None):
    """Launch the kernel. u: (Bt, T, d_in) bf16 or f32 and dt of the same
    shape in float32 (as the model makes it; dt is never cast), both
    contiguous; A: (d_in, N) with N <= 16; B/C:
    (Bt, T, N) in u's dtype, unit stride over N (their batch and time
    strides are passed to the kernel, so column slices need no copy); D:
    (d_in,); h0: (Bt, d_in, N) or None. A, D and h0 are read as float32: the
    wrapper casts them when they are not (at most d_in * N or Bt * d_in * N
    floats; the model passes float32). Returns (y (Bt, T, d_in) in u's
    dtype, h_T (Bt, d_in, N) float32)."""
    if u.dim() != 3 or dt.shape != u.shape or A.dim() != 2:
        raise ValueError(f"mamba_scan: want u = dt (Bt,T,d_in), A (d_in,N); got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}")
    bt, t, d_in = u.shape
    n = A.shape[1]
    want = {"A": (d_in, n), "B": (bt, t, n), "C": (bt, t, n), "D": (d_in,),
            "h0": (bt, d_in, n)}
    for name, x in (("A", A), ("B", B), ("C", C), ("D", D), ("h0", h0)):
        if x is not None and tuple(x.shape) != want[name]:
            raise ValueError(f"mamba_scan: {name} has shape {tuple(x.shape)}, "
                             f"want {want[name]}")
    require_cuda("mamba_scan", *(x for x in (u, dt, A, B, C, D, h0)
                                 if x is not None))
    if u.dtype not in DTYPE_CODES or dt.dtype != torch.float32:
        raise TypeError(f"mamba_scan: u {u.dtype}, dt {dt.dtype}; want u in "
                        f"{list(DTYPE_CODES)} and dt float32")
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"mamba_scan: B {B.dtype} and C {C.dtype} must have u's "
                        f"dtype {u.dtype}")
    if not 1 <= n <= MAX_N:
        raise NotImplementedError(f"mamba_scan: state width {n} outside "
                                  f"1..{MAX_N}")
    if t == 0 or bt > 65535:
        raise ValueError(f"mamba_scan: T = {t} must be >= 1 and Bt = {bt} "
                         "<= 65535")
    if not (u.is_contiguous() and dt.is_contiguous()):
        raise ValueError("mamba_scan: u and dt must be contiguous")
    if B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("mamba_scan: B and C need unit stride over N")
    A, D = (x.float().contiguous() for x in (A, D))
    if h0 is not None:
        h0 = h0.float().contiguous()
    y = torch.empty_like(u)
    h_t = torch.empty((bt, d_in, n), dtype=torch.float32, device=u.device)
    if bt == 0 or d_in == 0:
        return y, h_t
    lib = _build.load()
    _build.check(lib.mamba_scan_fwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_t.data_ptr(), bt, t, d_in, n, B.stride(0), B.stride(1), C.stride(0),
        C.stride(1), DTYPE_CODES[u.dtype], _build.stream_handle(u)),
        "mamba_scan_fwd")
    mamba_scan_cuda.launches += 1
    return y, h_t


mamba_scan_cuda.launches = 0


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """The kernel for CUDA tensors, the plain version for CPU tensors. The
    kernel has no backward yet: on the card a call that autograd would need
    a gradient of raises (Jamba trains after the scan's backward kernel,
    ROADMAP.md queue 2)."""
    if u.device.type == "cpu":
        return mamba_scan_plain(u, dt, A, B, C, D, h0)
    require_no_grad("mamba_scan", u, dt, A, B, C, D, h0)
    return mamba_scan_cuda(u, dt, A, B, C, D, h0)
