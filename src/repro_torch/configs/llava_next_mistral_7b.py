"""llava-next-mistral-7b [vlm]: mistral-7b backbone + anyres patch stub.
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].
Frontend is a STUB: input_specs() provides projected patch embeddings
(img_tokens=2880 = 5 anyres tiles x 576). Full attention -> long_500k
skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, img_tokens=2880, rope_theta=1_000_000.0)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, img_tokens=8, dtype="float32")
