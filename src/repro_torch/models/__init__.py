"""Model code of the port: decoder-only LMs of attention (GQA or
DeepSeek's MLA), Mamba (the Jamba hybrid), mLSTM and sLSTM (xLSTM) mixers,
each with a dense SwiGLU or a top-k mixture-of-experts FFN (``moe.py``).

Counterpart of :mod:`repro.models`: ``model_api(cfg)`` returns the
family-appropriate (init, loss, init_cache, decode_step) tuple. The MTP
branch of the loss and encoder-decoder models come with their own slices
(ROADMAP.md); until then those raise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import transformer
from .config import ModelConfig


class ModelAPI(NamedTuple):
    init: Callable          # (gen, cfg, device) -> params
    loss: Callable          # (params, batch, cfg) -> (loss, metrics)
    init_cache: Callable    # (cfg, batch, max_len, device) -> cache
    decode_step: Callable   # (params, cache, tokens, pos, cfg) -> (logits, cache)


def model_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models come with ROADMAP.md queue 1,"
            " item 4")
    return ModelAPI(transformer.init, transformer.lm_loss,
                    transformer.init_cache, transformer.decode_step)


__all__ = ["ModelConfig", "ModelAPI", "model_api", "transformer"]
