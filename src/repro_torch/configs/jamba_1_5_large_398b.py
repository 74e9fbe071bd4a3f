"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer. 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536 [arXiv:2403.19887; hf].
Period of 8: attention at position 0, mamba elsewhere; MoE on odd positions.
Hybrid (9 attention layers total) -> long_500k runs."""
from repro_torch.models.config import ModelConfig

_PERIOD = tuple(
    ("attn" if i == 0 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, period=_PERIOD,
    n_experts=16, top_k=2, d_expert=24576,
    ssm_state=16, ssm_conv=4, ssm_expand=2, mamba_chunk=64)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, period=_PERIOD,
    n_experts=4, top_k=2, d_expert=128,
    ssm_state=4, ssm_conv=4, ssm_expand=2, mamba_chunk=8, dtype="float32")
