"""Model code of the port: decoder-only LMs of attention (GQA or
DeepSeek's MLA), Mamba (the Jamba hybrid), mLSTM and sLSTM (xLSTM) mixers,
each with a dense SwiGLU or a top-k mixture-of-experts FFN (``moe.py``),
with DeepSeek's MTP branch in the loss; the Whisper-style encoder-decoder
(``encdec.py``); and the stub audio and image frontends (``frontends.py``).

Counterpart of :mod:`repro.models`: ``model_api(cfg)`` returns the
family-appropriate (init, loss, init_cache, decode_step) tuple.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import encdec, frontends, transformer
from .config import ModelConfig


class ModelAPI(NamedTuple):
    init: Callable          # (gen, cfg, device) -> params
    loss: Callable          # (params, batch, cfg) -> (loss, metrics)
    init_cache: Callable    # (cfg, batch, max_len[, ...], device=) -> cache
    decode_step: Callable   # (params, cache, tokens, pos, cfg) -> (logits, cache)


def model_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encdec:
        return ModelAPI(encdec.init, encdec.lm_loss, encdec.init_cache,
                        encdec.decode_step)
    return ModelAPI(transformer.init, transformer.lm_loss,
                    transformer.init_cache, transformer.decode_step)


__all__ = ["ModelConfig", "ModelAPI", "model_api", "transformer", "encdec",
           "frontends"]
