"""recurrentgemma-9b — Griffin: RG-LRU + local attention, 1 attn : 2 rec
[arXiv:2402.19427].

38 layers (12 x (rec, rec, attn) + 2 rec), d_model=4096, 16 MQA heads
(kv=1, head_dim 256), GeGLU d_ff=12288, vocab 256000, local window 2048.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    citation="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp="geglu",
    tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    local_window=2048,
)
