"""qwen2-1.5b — dense LLM with QKV bias [arXiv:2407.10671].

28 layers, d_model=1536, 12 heads (GQA kv=2, head_dim 128), d_ff=8960,
vocab 151936, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    citation="arXiv:2407.10671",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=True,
)
