"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf].
SWA window 4096 -> the KV cache is bounded, so long_500k decode runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, window=4096, rope_theta=10_000.0)

SMOKE = ModelConfig(
    name="h2o-danube-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, window=16, dtype="float32")
