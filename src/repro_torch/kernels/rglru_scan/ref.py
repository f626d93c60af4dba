"""Plain PyTorch version of the RG-LRU linear recurrence that the B9 kernel
computes: the sequential scan of ``repro/kernels/rglru_scan/ref.py``.

    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t),  a_t = exp(-8 r_t softplus(-lam))

with the Pallas kernel's operation order (``softplus(-lam)`` as
``logaddexp(0, -lam)``, ``sqrt(max(-expm1(2 log a), 1e-12))``).  The
wrapper runs it for CPU tensors; the model's ``rglru.rg_lru`` is this
function; the CUDA kernel is held against it on the card.
"""
from __future__ import annotations

import torch

_C = 8.0


def rglru_scan_ref(
    x: torch.Tensor,      # [B, S, W]
    r: torch.Tensor,      # [B, S, W] recurrence gate (sigmoid output)
    i: torch.Tensor,      # [B, S, W] input gate (sigmoid output)
    lam: torch.Tensor,    # [W]
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, W], h_last [B, W])."""
    sp = torch.logaddexp(torch.zeros_like(lam), -lam)
    log_a = -_C * r * sp
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) * (i * x)
    h = h0 if h0 is not None else torch.zeros_like(x[:, 0])
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x)
    return y, h
