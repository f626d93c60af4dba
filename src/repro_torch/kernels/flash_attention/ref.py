"""Plain PyTorch versions of the causal or full, optionally windowed, attention
forward and backward that the B7 and B8 kernels compute.

Counterpart of ``repro/kernels/flash_attention/ref.py``, in the model layout:
q and k [B, S, H or Hkv, D], v [B, S, Hkv, D_v], query head h reading KV
head h // (H / Hkv) (the reference's ``jnp.repeat`` of k and v, here a
broadcast).  The forward takes a value head size of its own, as the
reference's ``attention.attend_full`` / ``attend_chunked`` do (MLA's prefill
attends with q/k 192 = 128 nope + 64 rope and v 128); the scale is
``D^-½`` of the q/k head size.
Scores and probabilities are float32, masked with ``-1e30`` as the reference
masks them; the output comes back in q's dtype, with the row log-sum-exp
[B, H, S] that the Pallas kernel also returns.  It materialises the
[Sq, Sk] scores: the CUDA kernel beside it is held against it, and the
wrapper runs it for CPU tensors.

A query stripe: q may hold Sq <= Sk rows, query row i sitting at position
``q_offset + i`` of the keys' sequence (0 <= q_offset <= Sk - Sq), the
reference's ``attend_chunked(..., q_offset=)``: the causal rule keeps key j
where j <= q_offset + i, the window rule where j > q_offset + i - window.
lse is then [B, H, Sq].  The sequence-parallel attention of
``models/attention.py`` attends each model rank's stripe so.

:func:`flash_attention_bwd_ref` is the backward of the same function, at
MLA's unequal head sizes too (dq and dk D wide, dv D_v), with
the formulas of the reference's Pallas backward (``_dq_kernel``,
``_dkv_kernel``) in float32: ``p = exp(s - lse)`` masked to 0,
``dvec = rowsum(dO∘O)``, ``ds = p∘(dO·vᵀ - dvec)``, ``dq = D^-½·ds·k``,
``dk = D^-½·dsᵀ·q`` and ``dv = pᵀ·dO``, dk and dv summed over the query
heads of each KV head (in the reference that sum is autodiff through the
``jnp.repeat`` of k and v).  :func:`flash_attention_bwd_magnitudes` gives,
for each element of dq, dk and dv, the sum of the absolute values of the
terms that make it: a float32 result computed in another order lies within
a small multiple of eps of that sum, which is how the card's checks bound
each element (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def attention_mask(s: int, causal: bool, window: int | None, device, *,
                   s_k: int | None = None, q_offset: int = 0) -> torch.Tensor:
    """[S, S_k] boolean (S_k = S by default), True where query row i, at
    position ``q_offset + i``, attends key j."""
    q_pos = torch.arange(s, device=device) + q_offset
    k_pos = torch.arange(s if s_k is None else s_k, device=device)
    ok = torch.ones((s, k_pos.shape[0]), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D_v] in q's dtype, lse [B, H, Sq] float32)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,Sq,D]
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]                         # [B,Hkv,1,Sk,D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scores = (qg @ kf.transpose(-1, -2)) * d**-0.5
    mask = attention_mask(s, causal, window, q.device, s_k=k.shape[1], q_offset=q_offset)
    scores = scores.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.softmax(scores, dim=-1) @ vf                               # [B,Hkv,G,S,Dv]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, v.shape[-1])
    return out.to(q.dtype), lse.reshape(b, h, s)


def _grouped(q, k, v, do, lse, causal, window, q_offset):
    """The backward's float32 operands with the query heads grouped by KV
    head: q and dO [B, Hkv, G, Sq, D], k and v [B, Hkv, 1, Sk, D], and p
    [B, Hkv, G, Sq, Sk] recomputed from lse, masked to 0."""
    b, s, h, d = q.shape
    hkv = k.shape[2]

    def heads(x):
        return x.float().reshape(b, x.shape[1], hkv, -1, x.shape[-1]).permute(0, 2, 3, 1, 4)

    qg, dog, kf, vf = heads(q), heads(do), heads(k), heads(v)
    scores = (qg @ kf.transpose(-1, -2)) * d**-0.5
    p = torch.exp(scores - lse.reshape(b, hkv, h // hkv, s)[..., None])
    mask = attention_mask(s, causal, window, q.device, s_k=k.shape[1], q_offset=q_offset)
    p = p.masked_fill(~mask, 0.0)
    return qg, kf, vf, dog, p


def _ungroup(x, heads):
    """[B, Hkv, G, S, D] (or [B, Hkv, S, D] with ``heads`` = Hkv) -> [B, S, heads, D]."""
    b, s, d = x.shape[0], x.shape[-2], x.shape[-1]
    return x.reshape(b, heads, s, d).transpose(1, 2)


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq [B, Sq, H, D], dk [B, Sk, Hkv, D], dv [B, Sk, Hkv, D_v]) in q's
    dtype, from the forward's out [B, Sq, H, D_v] and lse [B, H, Sq] and
    the output gradient dO [B, Sq, H, D_v]."""
    h, hkv, scale = q.shape[2], k.shape[2], q.shape[-1] ** -0.5
    qg, kf, vf, dog, p = _grouped(q, k, v, do, lse, causal, window, q_offset)
    dvec = (do.float() * out.float()).sum(-1)                      # [B, S, H]
    dvec = dvec.transpose(1, 2).reshape(p.shape[:-1])              # [B, Hkv, G, S]
    ds = p * (dog @ vf.transpose(-1, -2) - dvec[..., None])
    dq = scale * (ds @ kf)
    dk = scale * (ds.transpose(-1, -2) @ qg).sum(2)
    dv = (p.transpose(-1, -2) @ dog).sum(2)
    return tuple(_ungroup(x, n).to(q.dtype).contiguous()
                 for x, n in ((dq, h), (dk, hkv), (dv, hkv)))


def flash_attention_bwd_magnitudes(q, k, v, out, lse, do, *, causal=True, window=None,
                                   q_offset=0):
    """Float32 (|dq|, |dk|, |dv|) term magnitudes [B, S, H or Hkv, D or D_v]: each
    element's sum of |term| over the products that make it, with ``ds``
    replaced by ``p·(|dO|·|v| + |dO|·|O|)`` (the size of the two dot
    products whose difference it is).  Arguments as
    :func:`flash_attention_bwd_ref`."""
    h, hkv, scale = q.shape[2], k.shape[2], q.shape[-1] ** -0.5
    qg, kf, vf, dog, p = _grouped(q, k, v, do, lse, causal, window, q_offset)
    dva = (do.float().abs() * out.float().abs()).sum(-1).transpose(1, 2)
    ds = p * (dog.abs() @ vf.abs().transpose(-1, -2) + dva.reshape(p.shape[:-1])[..., None])
    mq = scale * (ds @ kf.abs())
    mk = scale * (ds.transpose(-1, -2) @ qg.abs()).sum(2)
    mv = (p.transpose(-1, -2) @ dog.abs()).sum(2)
    return tuple(_ungroup(x, n) for x, n in ((mq, h), (mk, hkv), (mv, hkv)))
