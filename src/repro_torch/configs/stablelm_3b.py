"""stablelm-3b [dense]: MHA (kv=32). 32L d_model=2560 32H d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b lineage; unverified].
Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, dtype="float32")
