"""Plain PyTorch version of the RG-LRU linear recurrence that the B9 kernel
computes: the sequential scan of ``repro/kernels/rglru_scan/ref.py``.

    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t),  a_t = exp(-8 r_t softplus(-lam))

with the Pallas kernel's operation order (``softplus(-lam)`` as
``logaddexp(0, -lam)``, ``sqrt(max(-expm1(2 log a), 1e-12))``).  The
wrapper runs it for CPU tensors; the model's ``rglru.rg_lru`` is this
function; the CUDA kernel is held against it on the card.
:func:`rglru_scan_bwd_plain` is its backward, written out in torch
operations (no autograd), which the B9 backward kernel
(``csrc/rglru_scan_bwd.cu``) computes; :func:`rglru_scan_bwd_magnitudes`
the size of each output's terms, the scale of the card's per-element bar on
dlam.
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


def rglru_scan_bwd_plain(
    x: torch.Tensor,      # [B, S, W]
    r: torch.Tensor,      # [B, S, W]
    i: torch.Tensor,      # [B, S, W]
    lam: torch.Tensor,    # [W]
    y: torch.Tensor,      # [B, S, W] the forward's output (h), float32
    dy: torch.Tensor,     # [B, S, W]
    dh_last: torch.Tensor | None = None,  # [B, W]; None: zero
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`rglru_scan_ref` from h0 = 0: (dx, dr, di, dlam).

    With g_t the gradient of h_t (g_t = dy_t + a_{t+1} g_{t+1}, from
    g_{S-1} = dy_{S-1} + dh_last), u = -expm1(2 log a) and m =
    sqrt(max(u, 1e-12)):

        dx = g m i,  di = g m x,
        dlog_a = a g h_{t-1} - [u > 1e-12] a²/m (g i x)   (h_{-1} = 0),
        dr = dlog_a (-8 softplus(-lam)),
        dlam = Σ_{b,t} dlog_a (-8 r) (-sigmoid(-lam)).

    The clamp's subgradient is JAX's for ``maximum``: none to u where the
    clamp holds.  dx, dr and di come back in x's, r's and i's dtypes, dlam in
    lam's; the arithmetic is in the widest of x's dtype and float32."""
    return _rglru_bwd(x, r, i, lam, y, dy, dh_last, -1.0)


def rglru_scan_bwd_magnitudes(x, r, i, lam, y, dy, dh_last=None):
    """Each output element of :func:`rglru_scan_bwd_plain` as the sum of the
    absolute values of the terms that make it (float32 or wider): the same
    function of |x|, |y|, |dy| and |dh_last| with the difference in dlog_a
    turned into a sum.  Two float32 evaluations in other orders differ by a
    small multiple of eps times this (the bar of dlam, a sum over batch and
    time whose terms cancel)."""
    grads = _rglru_bwd(x.abs(), r, i, lam, y.abs(), dy.abs(),
                       None if dh_last is None else dh_last.abs(), 1.0, narrow=False)
    return tuple(g.abs() for g in grads)


def _rglru_bwd(x, r, i, lam, y, dy, dh_last, sign, narrow=True):
    """:func:`rglru_scan_bwd_plain` (``sign`` -1) or, on absolute values, its
    term magnitudes (``sign`` +1, ``narrow`` False: in the arithmetic's
    dtype)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    xf, rf, i_f, yf, dyf = (t.to(wide) for t in (x, r, i, y, dy))
    sp = torch.logaddexp(torch.zeros_like(lam), -lam).to(wide)
    log_a = -_C * rf * sp
    a = torch.exp(log_a)
    u = -torch.expm1(2.0 * log_a)
    m = torch.sqrt(torch.clamp(u, min=1e-12))
    g = torch.empty_like(dyf)
    carry = torch.zeros_like(dyf[:, 0]) if dh_last is None else dh_last.to(wide)
    for t in reversed(range(x.shape[1])):
        g[:, t] = dyf[:, t] + carry
        carry = a[:, t] * g[:, t]
    h_prev = torch.cat([torch.zeros_like(yf[:, :1]), yf[:, :-1]], dim=1)
    gix = g * i_f * xf
    dlog_a = a * g * h_prev + sign * torch.where(u > 1e-12, a * a / m, 0.0) * gix
    dr = dlog_a * (-_C * sp)
    dlam = (dlog_a * (-_C * rf)).sum((0, 1)) * -torch.sigmoid(-lam.to(wide))
    grads = (g * m * i_f, dr, g * m * xf, dlam)
    if not narrow:
        return grads
    return tuple(t.to(like.dtype) for t, like in zip(grads, (x, r, i, lam)))
