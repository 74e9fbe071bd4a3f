"""Selective scan (Mamba): the CUDA kernels ``csrc/mamba_scan.cu`` (forward)
and ``csrc/mamba_scan_bwd.cu`` (backward), and their plain versions.

Counterpart of :mod:`repro.kernels.mamba_scan` (``mamba_scan_pallas``): the
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t, y_t = C_t . h_t + D u_t
from ``h0`` (zeros when None), with float32 state. A CUDA tensor goes to the
kernel, a CPU tensor to :func:`mamba_scan_plain`, which autograd
differentiates. Where autograd needs a gradient of a CUDA call,
:class:`_MambaScan` runs the forward's training instance, which also saves
the state every ``STATE_EVERY`` steps (:func:`mamba_scan_train_cuda`), and
for the backward :func:`mamba_scan_bwd_cuda`, whose plain version is
:func:`mamba_scan_bwd_plain` (the reference differentiates its jnp scan).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._checks import DTYPE_CODES, require_cuda
from .ref import mamba_scan_bwd_ref as mamba_scan_bwd_plain
from .ref import mamba_scan_ref as mamba_scan_plain
from .ref import mamba_scan_states_ref as mamba_scan_states_plain

MAX_N = 16
# The kernel's launch plan (csrc/mamba_scan.cu): blocks of this many
# channels of one batch row, sized for this many resident blocks per SM.
CHANNELS_PER_BLOCK = 128
BLOCKS_PER_SM = 4
# the training instance saves the state at the start of every this many
# steps (the forward's stage); the backward (csrc/mamba_scan_bwd.cu) walks
# back over stages of as many steps, in blocks of 256 threads, four states a
# thread: 1024 / NM channels a block, NM = N rounded up to 4, 8 or 16, sized
# for BWD_BLOCKS_PER_SM resident blocks per SM (16 warps)
STATE_EVERY = 16
BWD_THREADS = 256
BWD_BLOCKS_PER_SM = 2


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


def bwd_blocks_per_sm(n: int, dtype: torch.dtype) -> int:
    """Blocks of the backward instance for state width ``n`` and u's
    ``dtype`` that one SM of the current card holds at once; the plan is
    sized for at least BWD_BLOCKS_PER_SM."""
    if dtype not in DTYPE_CODES or not 1 <= n <= MAX_N:
        raise ValueError(f"mamba_scan_bwd: no instance for n={n}, {dtype}")
    blocks = _build.load().mamba_scan_bwd_blocks_per_sm(n, DTYPE_CODES[dtype])
    if blocks < 0:
        raise RuntimeError("mamba_scan_bwd: the occupancy query failed")
    return blocks


def _check_fwd(name, u, dt, A, B, C, D, h0):
    """Raise on what the forward kernel does not take; returns (A, D, h0)
    as float32 and contiguous."""
    if u.dim() != 3 or dt.shape != u.shape or A.dim() != 2:
        raise ValueError(f"{name}: want u = dt (Bt,T,d_in), A (d_in,N); got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}")
    bt, t, d_in = u.shape
    n = A.shape[1]
    want = {"A": (d_in, n), "B": (bt, t, n), "C": (bt, t, n), "D": (d_in,),
            "h0": (bt, d_in, n)}
    for key, x in (("A", A), ("B", B), ("C", C), ("D", D), ("h0", h0)):
        if x is not None and tuple(x.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(x.shape)}, "
                             f"want {want[key]}")
    require_cuda(name, *(x for x in (u, dt, A, B, C, D, h0) if x is not None))
    if u.dtype not in DTYPE_CODES or dt.dtype != torch.float32:
        raise TypeError(f"{name}: u {u.dtype}, dt {dt.dtype}; want u in "
                        f"{list(DTYPE_CODES)} and dt float32")
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"{name}: B {B.dtype} and C {C.dtype} must have u's "
                        f"dtype {u.dtype}")
    if not 1 <= n <= MAX_N:
        raise NotImplementedError(f"{name}: state width {n} outside "
                                  f"1..{MAX_N}")
    if t == 0 or bt > 65535:
        raise ValueError(f"{name}: T = {t} must be >= 1 and Bt = {bt} "
                         "<= 65535")
    if not (u.is_contiguous() and dt.is_contiguous()):
        raise ValueError(f"{name}: u and dt must be contiguous")
    if B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError(f"{name}: B and C need unit stride over N")
    A, D = (x.float().contiguous() for x in (A, D))
    if h0 is not None:
        h0 = h0.float().contiguous()
    return A, D, h0


def _fwd(u, dt, A, B, C, D, h0, out) -> bool:
    """Launch the forward into ``out`` = (y, h_T, saved states or None: the
    serving instance); False when there is nothing to launch."""
    bt, t, d_in = u.shape
    if bt == 0 or d_in == 0:
        return False
    y, h_t, states = out
    _build.check(_build.load().mamba_scan_fwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_t.data_ptr(), None if states is None else states.data_ptr(), bt, t, d_in,
        A.shape[1], B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        DTYPE_CODES[u.dtype], _build.stream_handle(u)), "mamba_scan_fwd")
    return True


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
    A, D, h0 = _check_fwd("mamba_scan", u, dt, A, B, C, D, h0)
    y = torch.empty_like(u)
    h_t = torch.empty((u.shape[0], u.shape[2], A.shape[1]), dtype=torch.float32,
                      device=u.device)
    if _fwd(u, dt, A, B, C, D, h0, (y, h_t, None)):
        mamba_scan_cuda.launches += 1
    return y, h_t


mamba_scan_cuda.launches = 0


def n_states(t: int) -> int:
    """States the training instance saves for ``t`` steps."""
    return -(-t // STATE_EVERY)


def mamba_scan_train_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                          h0: Optional[torch.Tensor] = None):
    """The forward's training instance: :func:`mamba_scan_cuda`'s kernel,
    which also writes hs (Bt, ceil(T / STATE_EVERY), d_in, N) float32, the
    state at the start of every STATE_EVERY steps (h0 or zeros first).
    Returns (y, h_T, hs)."""
    A, D, h0 = _check_fwd("mamba_scan_train", u, dt, A, B, C, D, h0)
    bt, t, d_in = u.shape
    y = torch.empty_like(u)
    h_t = torch.empty((bt, d_in, A.shape[1]), dtype=torch.float32, device=u.device)
    hs = torch.empty((bt, n_states(t), d_in, A.shape[1]), dtype=torch.float32,
                     device=u.device)
    if _fwd(u, dt, A, B, C, D, h0, (y, h_t, hs)):
        mamba_scan_train_cuda.launches += 1
    return y, h_t, hs


mamba_scan_train_cuda.launches = 0


def bwd_blocks(d_in: int, n: int) -> int:
    """Blocks of the backward's first launch along d_in (each writes a
    partial row of dB / dC per step)."""
    nm = 4 if n <= 4 else 8 if n <= 8 else 16
    per = BWD_THREADS * 4 // nm
    return -(-d_in // per)


def mamba_scan_bwd_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                        hs: torch.Tensor, dy: torch.Tensor,
                        dh_t: Optional[torch.Tensor] = None):
    """Launch the backward kernel (two launches): the inputs as
    :func:`mamba_scan_cuda` takes them, ``hs`` as
    :func:`mamba_scan_train_cuda` returns it, dy (Bt, T, d_in) in u's dtype
    (made contiguous if it is not), dh_t (Bt, d_in, N) or None for zeros.
    Returns (du, ddt, dA, dB, dC, dD, dh0): du, dB, dC in u's dtype (dB and
    dC contiguous), the others float32."""
    A, D, _ = _check_fwd("mamba_scan_bwd", u, dt, A, B, C, D, None)
    bt, t, d_in = u.shape
    n = A.shape[1]
    require_cuda("mamba_scan_bwd", u, hs, dy, *(() if dh_t is None else (dh_t,)))
    if tuple(hs.shape) != (bt, n_states(t), d_in, n) or hs.dtype != torch.float32 \
            or not hs.is_contiguous():
        raise ValueError(f"mamba_scan_bwd: hs {hs.dtype} {tuple(hs.shape)}, want "
                         f"contiguous float32 {(bt, n_states(t), d_in, n)}")
    if dy.shape != u.shape or dy.dtype != u.dtype:
        raise ValueError(f"mamba_scan_bwd: dy {dy.dtype} {tuple(dy.shape)} does not "
                         f"match u {u.dtype} {tuple(u.shape)}")
    if dh_t is not None:
        if tuple(dh_t.shape) != (bt, d_in, n):
            raise ValueError(f"mamba_scan_bwd: dh_t has shape {tuple(dh_t.shape)}, "
                             f"want {(bt, d_in, n)}")
        dh_t = dh_t.float().contiguous()
    dy = dy.contiguous()
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddt = torch.empty_like(u), torch.empty(u.shape, **f32)
    dB, dC = (torch.empty((bt, t, n), dtype=u.dtype, device=u.device) for _ in range(2))
    dA, dD = torch.empty((d_in, n), **f32), torch.empty((d_in,), **f32)
    dh0 = torch.empty((bt, d_in, n), **f32)
    if bt == 0 or d_in == 0:
        return du, ddt, dA.zero_(), dB.zero_(), dC.zero_(), dD.zero_(), dh0
    blocks = bwd_blocks(d_in, n)
    part_bc = torch.empty((blocks, bt, t, 2 * n), **f32)
    part_a, part_d = torch.empty((bt, d_in, n), **f32), torch.empty((bt, d_in), **f32)
    _build.check(_build.load().mamba_scan_bwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), hs.data_ptr(), dy.data_ptr(),
        None if dh_t is None else dh_t.data_ptr(), du.data_ptr(), ddt.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
        part_bc.data_ptr(), part_a.data_ptr(), part_d.data_ptr(), blocks, bt, t,
        d_in, n, B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        DTYPE_CODES[u.dtype], _build.stream_handle(u)), "mamba_scan_bwd")
    mamba_scan_bwd_cuda.launches += 1
    return du, ddt, dA, dB, dC, dD, dh0


mamba_scan_bwd_cuda.launches = 0


class _MambaScan(torch.autograd.Function):
    """The forward's training instance, and the backward kernel for its
    gradient. A gradient autograd does not pass (h_T's, when the caller
    drops it) reaches the kernel as a null pointer, not a tensor of zeros."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, h0):
        y, h_t, hs = mamba_scan_train_cuda(u, dt, A, B, C, D, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, B, C, D, hs)
        ctx.h0 = None if h0 is None else h0.dtype
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        u, dt, A, B, C, D, hs = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        du, ddt, dA, dB, dC, dD, dh0 = mamba_scan_bwd_cuda(u, dt, A, B, C, D, hs, dy,
                                                           dh_t)
        # dt is float32 (the kernel takes no other); A, D and h0 are read as
        # float32 and their gradients go back in their own dtypes
        return (du, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype),
                None if ctx.h0 is None else dh0.to(ctx.h0))


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """The kernel for CUDA tensors (through :class:`_MambaScan` when
    autograd needs their gradient), the plain version for CPU tensors."""
    if u.device.type == "cpu":
        return mamba_scan_plain(u, dt, A, B, C, D, h0)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (u, dt, A, B, C, D, h0)):
        return _MambaScan.apply(u, dt, A, B, C, D, h0)
    return mamba_scan_cuda(u, dt, A, B, C, D, h0)
