"""Configs of the ported architectures (--arch <id>).

Each module exports CONFIG (full size) and SMOKE (reduced, CPU-runnable),
copied from the reference package. ``get(name)`` resolves by id with '-' or
'_' separators. The other architectures come with their slices (ROADMAP.md).
"""
from __future__ import annotations

import importlib

ARCHS = ["deepseek_v3_671b", "granite_3_2b", "h2o_danube_1_8b",
         "jamba_1_5_large_398b", "qwen3_moe_235b_a22b", "smollm_360m",
         "stablelm_3b", "xlstm_125m"]


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str, smoke: bool = False):
    cname = canon(name)
    if cname not in ARCHS:
        raise KeyError(f"architecture {name!r} is not ported yet; have {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{cname}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs():
    return list(ARCHS)
