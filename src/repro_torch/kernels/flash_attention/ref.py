"""Plain PyTorch version of the causal (optionally windowed) attention
forward that the B7 kernel computes.

Counterpart of ``repro/kernels/flash_attention/ref.py``, in the model layout:
q [B, S, H, D], k and v [B, S, Hkv, D], query head h reading KV head
h // (H / Hkv) (the reference's ``jnp.repeat`` of k and v, here a broadcast).
Scores and probabilities are float32, masked with ``-1e30`` as the reference
masks them; the output comes back in q's dtype, with the row log-sum-exp
[B, H, S] that the Pallas kernel also returns.  It materialises the
[S, S] scores: the CUDA kernel beside it is held against it, and the wrapper
runs it for CPU tensors.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def attention_mask(s: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """[S, S] boolean, True where query i attends key j."""
    pos = torch.arange(s, device=device)
    ok = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= pos[None, :] > pos[:, None] - window
    return ok


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, H, D] in q's dtype, lse [B, H, S] float32)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,S,D]
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]                         # [B,Hkv,1,S,D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scores = (qg @ kf.transpose(-1, -2)) * d**-0.5
    scores = scores.masked_fill(~attention_mask(s, causal, window, q.device), _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.softmax(scores, dim=-1) @ vf                               # [B,Hkv,G,S,D]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return out.to(q.dtype), lse.reshape(b, h, s)
