"""Model configuration covering all ten assigned architectures.

A model is a stack of *blocks*; each block has a ``mixer`` (token mixing:
attention variants, Mamba, sLSTM, mLSTM) and an optional ``ffn`` (dense MLP or
MoE).  Periodic patterns (Jamba's [attn + 7 mamba], xLSTM's alternation,
DeepSeek's dense prefix) are expressed with ``period`` + ``first_k_dense``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

BlockSpec = Tuple[str, Optional[str]]           # (mixer, ffn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    period: Tuple[BlockSpec, ...] = (("attn", "mlp"),)
    window: Optional[int] = None      # sliding-window attention width
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 8192               # learned-positions budget (enc-dec only)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0            # DeepSeek: dense FFN for first k layers
    router_aux_weight: float = 0.001
    moe_dispatch_groups: int = 1      # grouped local dispatch (H3, a2a-shaped)
    moe_combine_dtype: str = "float32"  # scatter-add accumulator (H3 iter-3:
                                        # bfloat16 halves combine traffic)

    # --- MLA (DeepSeek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / xLSTM ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    lstm_chunk: int = 64              # mLSTM chunkwise block length

    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500           # post-conv frames (frontend stubbed)

    # --- VLM (LLaVA) ---
    img_tokens: int = 0               # stub patch embeddings per sample

    # --- DeepSeek MTP ---
    mtp: bool = False
    mtp_weight: float = 0.3

    # --- runtime ---
    force_fsdp: bool = False          # ZeRO-3 sharding even for small models
    pure_dp: bool = False             # no TP: replicate params, batch over
                                      # every mesh axis (right-sizing for
                                      # sub-1B models; EXPERIMENTS.md H1)
    seq_shard: bool = False           # context parallelism: shard the
                                      # sequence dim over 'model' (long
                                      # prefill; EXPERIMENTS.md H2)
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "jnp"            # jnp | pallas | ref
    q_chunk: int = 1024
    kv_chunk: int = 1024
    mamba_chunk: int = 64

    def __post_init__(self):
        assert self.n_layers % len(self.period) == 0, \
            f"{self.name}: n_layers {self.n_layers} not divisible by " \
            f"period {len(self.period)}"
        if self.first_k_dense:
            assert len(self.period) == 1, "dense prefix needs uniform period"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.period)

    @property
    def d_inner(self) -> int:          # mamba / mLSTM expanded width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def blocks(self) -> Sequence[BlockSpec]:
        """Full per-layer (mixer, ffn) list, including the dense prefix."""
        out = [("attn" if not self.mla else "mla", "mlp")] * self.first_k_dense
        body = list(self.period) * self.n_periods
        return out + body

    # rough parameter counts, used for roofline MODEL_FLOPS = 6 N D
    def param_count(self) -> Tuple[int, int]:
        """(total_params, active_params_per_token)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        active = total
        for mixer, ffn in self.blocks():
            pm = self._mixer_params(mixer)
            total += pm
            active += pm
            if ffn == "mlp":
                pf = 3 * d * self.d_ff
                total += pf
                active += pf
            elif ffn == "moe":
                pe = 3 * d * self.d_expert
                total += self.n_experts * pe + d * self.n_experts
                active += (self.top_k + self.n_shared_experts) * pe
                total += self.n_shared_experts * pe
            total += 2 * d                       # norms
            active += 2 * d
        if self.is_encdec:                        # encoder stack + cross attn
            enc = self.encoder_layers * (4 * d * d + 3 * d * self.d_ff + 2 * d)
            cross = self.n_layers * 4 * d * d
            total += enc + cross
            active += enc + cross
        return total, active

    def _mixer_params(self, mixer: str) -> int:
        d = self.d_model
        if mixer == "attn":
            q = d * self.n_heads * self.hd
            kv = 2 * d * self.n_kv_heads * self.hd
            o = self.n_heads * self.hd * d
            return q + kv + o
        if mixer == "mla":
            qk_head = self.qk_nope_head_dim + self.qk_rope_head_dim
            p = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk_head
            p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_head_dim + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        if mixer == "mamba":
            di, n = self.d_inner, self.ssm_state
            p = d * 2 * di                        # in proj (x, z)
            p += di * self.ssm_conv               # conv
            p += di * (self.dt_rank + 2 * n)      # x -> dt, B, C
            p += self.dt_rank * di + di * n + di  # dt proj, A, D
            p += di * d                           # out proj
            return p
        if mixer in ("slstm", "mlstm"):
            di = self.d_inner
            if mixer == "mlstm":
                return d * 2 * di + di * 3 * di + 2 * d * self.n_heads \
                    + di * d + di * self.ssm_conv
            return 4 * d * d + 4 * d * d // self.n_heads + d * d
        raise ValueError(mixer)
