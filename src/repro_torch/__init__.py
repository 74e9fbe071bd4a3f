"""PyTorch and CUDA port of the repro model path, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it. Plain tensor code is PyTorch, and each Pallas TPU kernel on a ported
path is a CUDA kernel written for Hopper (``csrc/``), built at first use by
:mod:`repro_torch.kernels._build`. Entry points take ``device=`` and default
to ``"cuda"``; with no GPU they raise unless the caller asks for the CPU,
where every kernel's plain version runs.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises RuntimeError for a CUDA device
    when none is available, so nothing carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev
