"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 MoE
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24 layers, d_model=2048, 16 heads (kv=16), expert d_ff=1408, vocab 151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    rope_theta=1e6,
    qkv_bias=True,
    moe=True,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    d_ff_expert=1408,
)
