"""deepseek-v2-236b — MoE with Multi-head Latent Attention
[arXiv:2405.04434].

60 layers, d_model=5120, 128 heads, MLA (kv_lora 512, q_lora 1536, nope 128,
rope 64, v 128), 160 routed experts (d_ff 1536) top-6 + 2 shared, first
layer dense (d_ff 12288), vocab 102400.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    citation="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    moe=True,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    first_dense_layers=1,
    d_ff_dense=12288,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
)
