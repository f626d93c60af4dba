"""mamba2-780m — attention-free SSD state-space model [arXiv:2405.21060].

48 layers, d_model=1536 (d_inner 3072, 48 heads of dim 64), ssm_state=128,
vocab 50280, tied LM head.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    citation="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    n_heads=1,   # unused by the SSM family (heads derive from d_inner)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
