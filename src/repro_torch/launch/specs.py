"""Stand-ins for every model input of a dry-run cell (no allocation).

Counterpart of the reference's ``launch/specs.py``. Torch has no
``ShapeDtypeStruct``: the stand-ins are tensors on ``device="meta"``, which
hold a shape and a dtype and no storage. ``input_specs(cfg, shape_name)``
returns the batch of a train or prefill cell, or (cache, tokens, pos) of a
decode cell, the cache built by the port's own ``init_cache`` (an
encoder-decoder's by ``encdec.init_cache``) on the meta device.
``cell_plan`` decides which cells apply (``long_500k`` needs sub-quadratic
attention).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import encdec, model_api
from repro_torch.models.config import ModelConfig

SHAPES: Dict[str, Tuple[int, int, str]] = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# archs allowed to run long_500k (the sub-quadratic families)
LONG_OK_FAMILIES = {"ssm", "hybrid"}


def long_ok(cfg: ModelConfig) -> bool:
    return cfg.family in LONG_OK_FAMILIES or cfg.window is not None


def cell_plan(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if the cell runs, else the reason it is skipped."""
    if shape_name == "long_500k" and not long_ok(cfg):
        return ("pure full-attention arch: unwindowed 524288-token cache is "
                "the disallowed quadratic-family case (DESIGN.md §4)")
    return None


def _sd(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int) -> Dict:
    if cfg.family == "vlm":
        return {"embeds": _sd((batch, seq, cfg.d_model), torch.float32),
                "labels": _sd((batch, seq)),
                "mask": _sd((batch, seq), torch.float32)}
    if cfg.family == "audio":
        return {"frames": _sd((batch, cfg.encoder_seq, cfg.d_model),
                              torch.float32),
                "inputs": _sd((batch, seq)),
                "labels": _sd((batch, seq))}
    return {"inputs": _sd((batch, seq)), "labels": _sd((batch, seq))}


def decode_input_specs(cfg: ModelConfig, seq: int, batch: int):
    """(cache, tokens, pos) of one serve step."""
    if cfg.is_encdec:
        cache = encdec.init_cache(cfg, batch, max_len=seq, device="meta")
    else:
        cache = model_api(cfg).init_cache(cfg, batch, max_len=seq,
                                          device="meta")
    return cache, _sd((batch,)), _sd((), torch.int32)


def input_specs(cfg: ModelConfig, shape_name: str):
    seq, batch, kind = SHAPES[shape_name]
    if kind in ("train", "prefill"):
        return train_batch_specs(cfg, seq, batch)
    return decode_input_specs(cfg, seq, batch)
