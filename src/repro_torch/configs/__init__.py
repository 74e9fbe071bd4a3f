"""Configs of the ported architectures (--arch <id>).

Each module exports CONFIG (full size) and SMOKE (reduced, CPU-runnable),
copied from the reference package. ``get(name)`` resolves by id with '-' or
'_' separators. Every architecture of the reference is here.
"""
from __future__ import annotations

import importlib

ARCHS = ["deepseek_v3_671b", "granite_3_2b", "h2o_danube_1_8b",
         "jamba_1_5_large_398b", "llava_next_mistral_7b",
         "qwen3_moe_235b_a22b", "smollm_360m", "stablelm_3b",
         "whisper_small", "xlstm_125m"]


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str, smoke: bool = False):
    cname = canon(name)
    if cname not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; have {ARCHS} (the "
                       "reference's hillclimb variants come with ROADMAP.md "
                       "queue 1, item 6)")
    mod = importlib.import_module(f"repro_torch.configs.{cname}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs():
    return list(ARCHS)
