"""Architecture configuration — one dataclass covers all six families.

Every assigned architecture (DESIGN.md §4) instantiates ``ArchConfig`` with
its exact published numbers; reduced smoke variants are derived with
``.reduced()``.  Family-specific fields are ignored by other families.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "vlm", "moe", "ssm", "hybrid", "encdec"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    citation: str

    # --- transformer backbone ---
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // n_heads
    rope_theta: float = 10000.0
    max_seq_len: int = 131072
    qk_norm: bool = False                # qwen3-style per-head RMSNorm on q/k
    qkv_bias: bool = False               # qwen2-style bias on qkv projections
    norm: str = "rmsnorm"                # "rmsnorm" | "layernorm"
    use_rope: bool = True                # whisper uses absolute positions
    mlp: str = "swiglu"                  # "swiglu" | "geglu" | "gelu_mlp"
    tie_embeddings: bool = False
    sliding_window: int | None = None    # local-attention window (tokens)

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0          # deepseek: layer 0 uses a dense FFN
    d_ff_dense: int = 0                  # width of those dense FFN layers
    router_aux_coef: float = 0.001

    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1

    # --- hybrid (recurrentgemma) ---
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int | None = None
    local_window: int = 2048

    # --- enc-dec (whisper) / vlm frontends (stubs per spec) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0                 # whisper: 1500 conv-output frames
    n_patches: int = 0                   # vlm: vision tokens per image
    d_frontend: int = 0                  # frontend embedding dim (pre-projector)
    decoder_ctx: int = 0                 # whisper decoder context (448)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_layers(self) -> int:
        """Number of attention layers (hybrid archs have fewer)."""
        if self.family == "hybrid" and self.block_pattern:
            full, rem = divmod(self.n_layers, len(self.block_pattern))
            n = full * sum(1 for b in self.block_pattern if b == "attn")
            n += sum(1 for b in self.block_pattern[:rem] if b == "attn")
            return n
        return self.n_layers

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2-ish layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        head_dim = max(16, d_model // n_heads)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        changes = dict(
            name=self.name + "-smoke",
            n_layers=max(2, len(self.block_pattern)) if self.family == "hybrid" else 2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=512,
        )
        if self.moe:
            changes.update(
                n_experts=min(self.n_experts, 4),
                n_shared_experts=min(self.n_shared_experts, 1),
                top_k=min(self.top_k, 2),
                d_ff_expert=min(self.d_ff_expert, 128),
                first_dense_layers=min(self.first_dense_layers, 1),
                d_ff_dense=min(self.d_ff_dense, 256),
            )
        if self.mla:
            changes.update(
                kv_lora_rank=64,
                q_lora_rank=0 if self.q_lora_rank == 0 else 64,
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        if self.family == "ssm":
            changes.update(ssm_state=32, ssm_head_dim=16, ssm_chunk=32)
        if self.family == "hybrid":
            changes.update(lru_width=d_model, local_window=64)
        if self.sliding_window:
            changes.update(sliding_window=128)
        if self.family == "encdec":
            changes.update(n_encoder_layers=2, encoder_seq=32, decoder_ctx=64)
        if self.family == "vlm":
            changes.update(n_patches=8, d_frontend=64)
        return dataclasses.replace(self, **changes)
