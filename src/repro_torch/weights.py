"""Transplant reference parameters and optimizer states into the port.

The port keeps the reference's parameter tree (same dict keys, same
``x @ W`` layouts, same stacked leading axis) and its optimizer states'
layout, so a transplant is a tree map.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model_api
from repro_torch.models.config import ModelConfig


def from_jax_params(tree, cfg: ModelConfig, device="cuda"):
    """Nested dicts and lists of numpy arrays (``np.asarray`` of each leaf
    of the reference's ``init``: DeepSeek's dense prefix is a list of
    layers) -> the port's parameter tree on ``device``.

    Key sets, list lengths and shapes are checked against the port's
    ``model_api(cfg).init`` (the decoder-only or the encoder-decoder
    tree); any mismatch raises ValueError. Each leaf takes the dtype the port's ``init``
    gives it: the config's dtype for weights; float32 for norm scales,
    Mamba's ``A_log``, ``D`` and ``dt_bias`` and xLSTM's gate weights and
    biases, as in the reference, so a bf16 model does not round them.
    """
    dev = resolve_device(device)
    template = model_api(cfg).init(torch.Generator(), cfg, device="meta")

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
        if isinstance(tmpl, list):
            if not isinstance(src, (list, tuple)) or len(src) != len(tmpl):
                raise ValueError(
                    f"{path}: expected a list of {len(tmpl)} layers, got "
                    + (f"{len(src)}" if isinstance(src, (list, tuple))
                       else type(src).__name__))
            return [convert(a, t, f"{path}/{i}")
                    for i, (a, t) in enumerate(zip(src, tmpl))]
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(tmpl.shape)}")
        # bf16 has no numpy dtype: go through a float32 copy
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=dev, dtype=tmpl.dtype)

    return convert(tree, template, "")


def from_jax_opt_state(tree, params_template, device="cuda"):
    """The reference's AdamW state ({'mu', 'nu', 'step'}) or Adafactor state
    ({'stats', 'step'}), as numpy (``np.asarray`` of each leaf), -> the
    port's, on ``device``: float32 moments and statistics in the params'
    tree, ``step`` a 0-d int32 tensor. ``params_template`` is the port's parameter tree
    (its leaves' shapes are checked; any mismatch raises ValueError)."""
    dev = resolve_device(device)

    def f32(src, shape, path):
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)

    def walk(src, tmpl, path, leaf):
        if isinstance(tmpl, dict):
            if not isinstance(src, dict) or set(src) != set(tmpl):
                raise ValueError(f"{path or '<root>'}: keys "
                                 f"{sorted(src) if isinstance(src, dict) else src}"
                                 f" do not match the params' {sorted(tmpl)}")
            return {k: walk(src[k], tmpl[k], f"{path}/{k}", leaf)
                    for k in tmpl}
        return leaf(src, tmpl, path)

    def moments(src, p, path):
        return f32(src, p.shape, path)

    def stats(src, p, path):
        if p.dim() >= 2:
            want = {"vr": p.shape[:-1], "vc": p.shape[:-2] + p.shape[-1:]}
        else:
            want = {"v": p.shape}
        if set(src) != set(want):
            raise ValueError(f"{path}: statistics {sorted(src)}, expected "
                             f"{sorted(want)}")
        return {k: f32(src[k], want[k], f"{path}/{k}") for k in want}

    step = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                        device=dev)
    if set(tree) == {"mu", "nu", "step"}:
        return {"mu": walk(tree["mu"], params_template, "mu", moments),
                "nu": walk(tree["nu"], params_template, "nu", moments),
                "step": step}
    if set(tree) == {"stats", "step"}:
        return {"stats": walk(tree["stats"], params_template, "stats", stats),
                "step": step}
    raise ValueError(f"not an AdamW or Adafactor state: keys {sorted(tree)}")
