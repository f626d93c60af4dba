"""mistral-nemo-12b — dense 128k-context LLM
[hf:mistralai/Mistral-Nemo-Base-2407].

40 layers, d_model=5120, 32 heads (GQA kv=8, head_dim 128), d_ff=14336,
vocab 131072, rope theta 1e6.  Base model uses full attention; the
long_500k decode shape runs the sliding-window (4096) variant (DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    max_seq_len=131072,
)
