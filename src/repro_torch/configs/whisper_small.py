"""whisper-small [audio]: encoder-decoder, conv frontend STUBBED
(input_specs provides post-conv frame embeddings (B, 1500, 768)).
12+12L d_model=768 12H d_ff=3072 vocab=51865 [arXiv:2212.04356; unverified].
Enc-dec (not encoder-only) -> decode shapes lower serve_step."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, encoder_layers=12, encoder_seq=1500,
    max_seq=32768, tie_embeddings=True,
    # unroll the 12-layer stacks: enc-dec has no scan-body cost correction
    # in the dry-run, so unrolled HLO keeps the roofline FLOPs exact; large
    # attention chunks keep the unrolled blockwise HLO compile-tractable
    scan_layers=False, q_chunk=4096, kv_chunk=4096)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, encoder_layers=2, encoder_seq=32,
    max_seq=64, tie_embeddings=True, dtype="float32")
