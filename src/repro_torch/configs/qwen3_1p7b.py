"""qwen3-1.7b — dense LLM with per-head q/k RMSNorm [hf:Qwen/Qwen3-8B].

28 layers, d_model=2048, 16 heads (GQA kv=8, head_dim 128), d_ff=6144,
vocab 151936, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
)
