"""Transplant reference parameters into the port.

The port keeps the reference's parameter tree (same dict keys, same
``x @ W`` layouts, same stacked leading axis), so a transplant is a tree map.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def from_jax_params(tree, cfg: ModelConfig, device="cuda"):
    """Nested dicts of numpy arrays (``np.asarray`` of each leaf of the
    reference's ``init``) -> the port's parameter tree on ``device``.

    Key sets and shapes are checked against the port's ``init(cfg)``; any
    mismatch raises ValueError. Each leaf takes the dtype the port's ``init``
    gives it: the config's dtype for weights; float32 for norm scales,
    Mamba's ``A_log``, ``D`` and ``dt_bias`` and xLSTM's gate weights and
    biases, as in the reference, so a bf16 model does not round them.
    """
    dev = resolve_device(device)
    template = transformer.init(torch.Generator(), cfg, device="meta")

    def convert(src, tmpl, path):
        if isinstance(tmpl, dict):
            if not isinstance(src, dict):
                raise ValueError(f"{path or '<root>'}: expected a dict, got "
                                 f"{type(src).__name__}")
            missing, extra = set(tmpl) - set(src), set(src) - set(tmpl)
            if missing or extra:
                raise ValueError(f"{path or '<root>'}: missing keys "
                                 f"{sorted(missing)}, unexpected keys "
                                 f"{sorted(extra)}")
            return {k: convert(src[k], tmpl[k], f"{path}/{k}") for k in tmpl}
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(tmpl.shape)}")
        # bf16 has no numpy dtype: go through a float32 copy
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=dev, dtype=tmpl.dtype)

    return convert(tree, template, "")
