"""internvl2-2b — InternViT(stub) + InternLM2-1.8B decoder [arXiv:2404.16821].

24 layers, d_model=2048, 16 heads (GQA kv=8), d_ff=8192, vocab 92553.
The vision encoder is a stub: input_specs provides 256 patch embeddings of
dim 1024 (InternViT-300M output); the MLP projector is part of this model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    citation="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1e6,
    tie_embeddings=False,
    n_patches=256,
    d_frontend=1024,
)
