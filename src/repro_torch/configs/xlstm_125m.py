"""xlstm-125m [ssm]: alternating sLSTM + mLSTM blocks, no FFN (d_ff=0).
12L d_model=768 4H vocab=50304 [arXiv:2405.04517; unverified].
Recurrent state -> long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    period=(("slstm", None), ("mlstm", None)),
    ssm_expand=2, ssm_conv=4, lstm_chunk=256, tie_embeddings=True)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=256,
    period=(("slstm", None), ("mlstm", None)),
    ssm_expand=2, ssm_conv=4, lstm_chunk=16, tie_embeddings=True,
    dtype="float32")
