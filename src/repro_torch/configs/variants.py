"""Hillclimb variant configs.

Counterpart of the reference's ``configs/variants.py``: each variant is one
hypothesis -> change step against a baseline config, copied field for
field. Baseline configs are never mutated, so both stay reportable side by
side. ``configs.get`` resolves a variant by its key or by its display name
("smollm-360m+padheads+puredp"). The sharding fields they set
(``force_fsdp``, ``pure_dp``, ``seq_shard``) take effect under a mesh
(:mod:`repro_torch.launch.mesh`, :mod:`repro_torch.launch.shardings`).
"""
from __future__ import annotations

import dataclasses

from .h2o_danube_1_8b import CONFIG as _danube
from .qwen3_moe_235b_a22b import CONFIG as _qwen3
from .smollm_360m import CONFIG as _smollm
from .whisper_small import CONFIG as _whisper
from .xlstm_125m import CONFIG as _xlstm

# H1 (smollm train/prefill): 15 q-heads / 5 kv-heads don't divide a 16-way
# model axis. Pad to 16 q / 8 kv heads (+2.3% params, GQA group 3 -> 2).
smollm_360m_padheads = dataclasses.replace(
    _smollm, name="smollm-360m+padheads", n_heads=16, n_kv_heads=8,
    head_dim=64)

# H2 (danube prefill_32k): larger attention chunks, fewer block boundaries.
h2o_danube_1_8b_bigchunk = dataclasses.replace(
    _danube, name="h2o-danube-1.8b+bigchunk", q_chunk=2048, kv_chunk=2048)

# H3 (qwen3 train, MoE dispatch): capacity factor 1.0.
qwen3_moe_235b_a22b_cap1 = dataclasses.replace(
    _qwen3, name="qwen3-moe-235b-a22b+cap1", capacity_factor=1.0)

# H1 iteration 2: FSDP (ZeRO-3) over 'data'.
smollm_360m_padheads_fsdp = dataclasses.replace(
    smollm_360m_padheads, name="smollm-360m+padheads+fsdp", force_fsdp=True)

# H1 iteration 3: pure data parallelism, the batch over every mesh axis and
# the params replicated.
smollm_360m_padheads_dp = dataclasses.replace(
    smollm_360m_padheads, name="smollm-360m+padheads+puredp", pure_dp=True)

# H2: context parallelism (the sequence over 'model', the batch over 'data').
h2o_danube_1_8b_seqp = dataclasses.replace(
    _danube, name="h2o-danube-1.8b+seqp", pure_dp=True, seq_shard=True)

# H3 iteration 2: grouped local dispatch, one group per data shard.
qwen3_moe_235b_a22b_cap1_grouped = dataclasses.replace(
    qwen3_moe_235b_a22b_cap1, name="qwen3-moe-235b-a22b+cap1+grouped",
    moe_dispatch_groups=16)

# H3 iteration 3: the combine sums the top-k contributions in bf16.
qwen3_moe_235b_a22b_cg_bf16 = dataclasses.replace(
    qwen3_moe_235b_a22b_cap1_grouped,
    name="qwen3-moe-235b-a22b+cap1+grouped+bf16c",
    moe_combine_dtype="bfloat16")

# H1 generalisation: pure data parallelism for the sub-1B models.
xlstm_125m_puredp = dataclasses.replace(
    _xlstm, name="xlstm-125m+puredp", pure_dp=True)
whisper_small_puredp = dataclasses.replace(
    _whisper, name="whisper-small+puredp", pure_dp=True)

VARIANTS = {
    "xlstm_125m_puredp": xlstm_125m_puredp,
    "whisper_small_puredp": whisper_small_puredp,
    "qwen3_moe_235b_a22b_cg_bf16": qwen3_moe_235b_a22b_cg_bf16,
    "qwen3_moe_235b_a22b_cap1_grouped": qwen3_moe_235b_a22b_cap1_grouped,
    "h2o_danube_1_8b_seqp": h2o_danube_1_8b_seqp,
    "smollm_360m_padheads_dp": smollm_360m_padheads_dp,
    "smollm_360m_padheads_fsdp": smollm_360m_padheads_fsdp,
    "smollm_360m_padheads": smollm_360m_padheads,
    "h2o_danube_1_8b_bigchunk": h2o_danube_1_8b_bigchunk,
    "qwen3_moe_235b_a22b_cap1": qwen3_moe_235b_a22b_cap1,
}

# display names ("smollm-360m+padheads+puredp") resolve too
for _cfg in list(VARIANTS.values()):
    _key = _cfg.name.replace("-", "_").replace(".", "_").replace("+", "_")
    VARIANTS.setdefault(_key, _cfg)
