"""Stub modality frontends: synthetic frontend outputs of the shapes and
dtypes the backbones take (the reference stubs the audio conv stack and the
vision tower the same way).

Counterpart of :mod:`repro.models.frontends`. The draws come from an
explicit ``torch.Generator`` (where it lives) and are placed on ``device``;
the reference's ``jax.random`` keys give other numbers from the same seed.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from .config import ModelConfig


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    dev = resolve_device(device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * 0.02).to(dev)


def audio_frames(gen: torch.Generator, cfg: ModelConfig, batch: int,
                 device="cuda") -> torch.Tensor:
    """Whisper stub: post-conv frame embeddings (B, enc_seq, D), float32."""
    return _normal(gen, (batch, cfg.encoder_seq, cfg.d_model), device)


def image_patches(gen: torch.Generator, cfg: ModelConfig, batch: int,
                  device="cuda") -> torch.Tensor:
    """LLaVA anyres stub: projected patch embeddings (B, img_tokens, D),
    float32. Real LLaVA-NeXT tiles the image (anyres) into up to 5 crops of
    576 patches; ``cfg.img_tokens`` carries the flattened count."""
    return _normal(gen, (batch, cfg.img_tokens, cfg.d_model), device)


def fuse_vlm_inputs(params, patches, tokens, cfg: ModelConfig) -> torch.Tensor:
    """[img patches; text embeds] -> (B, img_tokens + text_len, D) in the
    embedding's dtype."""
    text = params["embed"][tokens]
    return torch.cat([patches.to(text.dtype), text], dim=1)
