"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed experts top-8, MTP.
61L d_model=7168 128H d_ff(expert)=2048 vocab=129280 [arXiv:2412.19437; hf].
First 3 layers dense-FFN; MLA dims per the paper (q_lora 1536, kv_lora 512,
qk 128+64 rope, v 128). Full-softmax attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280, period=(("mla", "moe"),), first_k_dense=3,
    n_experts=256, top_k=8, d_expert=2048, n_shared_experts=1,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mtp=True, rope_theta=10_000.0)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=256, period=(("mla", "moe"),), first_k_dense=1,
    n_experts=8, top_k=2, d_expert=48, n_shared_experts=1,
    mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    mtp=True, dtype="float32")
