"""Causal (or full), optionally windowed, flash attention: the forward (B7)
and the backward (B8) as CUDA kernels, their wrappers and plain versions,
and the autograd Function over both."""
from repro_torch.kernels.flash_attention.ops import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_magnitudes,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_magnitudes", "flash_attention_bwd_ref",
           "flash_attention_ref"]
