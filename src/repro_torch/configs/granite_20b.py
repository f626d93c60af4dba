"""granite-20b — llama-arch code model, MQA [arXiv:2405.04324].

52 layers, d_model=6144, 48 heads (kv=1 MQA, head_dim 128), d_ff=24576,
vocab 49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    citation="arXiv:2405.04324",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
)
