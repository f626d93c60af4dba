"""whisper-tiny — encoder-decoder ASR backbone [arXiv:2212.04356].

4 decoder (and 4 encoder) layers, d_model=384, 6 heads (kv=6), d_ff=1536,
vocab 51865.  The mel+conv frontend is a stub (input_specs provides the 1500
conv-output frames).  max_seq_len is raised to 32k so the decode_32k dry-run
shape has a position table; long_500k is skipped (full attention, DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    citation="arXiv:2212.04356",
    n_layers=4,
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    mlp="gelu_mlp",
    use_rope=False,
    tie_embeddings=True,
    encoder_seq=1500,
    decoder_ctx=448,
    max_seq_len=32768,
)
