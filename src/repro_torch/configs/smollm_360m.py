"""smollm-360m [dense]: llama-arch small model.
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M family; hf]. Pure full attention ->
long_500k skipped (DESIGN.md SS4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, tie_embeddings=True)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
    d_ff=96, vocab=256, tie_embeddings=True, dtype="float32")
