"""Plain PyTorch versions of the Mamba-2 SSD scan that the B10 kernel
computes, in the model layout with B and C per group: xdt [B, S, H, P]
(x · dt), la [B, S, H] (log decay per step, <= 0), b and c [B, S, G, N],
head h reading group h // (H / G).  Both return
``(y [B, S, H, P], h_final [B, H, P, N])``, float32.

* :func:`ssd_chunk_ref` — the sequential recurrence of
  ``repro/kernels/ssd_chunk/ref.py``, h_t = exp(la_t) h_{t-1} + xdt_t ⊗ b_t,
  y_t = h_t c_t: the oracle, for the tests.
* :func:`ssd_chunk_plain` — the chunked algorithm of
  ``repro/models/mamba2.py``'s ``ssd_chunked`` (intra-chunk quadratic form,
  inter-chunk state carried over the chunks): the wrapper runs it for CPU
  tensors, the model's ``mamba2.ssd_chunked`` is it, and the CUDA kernel is
  held against it on the card.
"""
from __future__ import annotations

import torch


def _per_head(t: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """Repeat a group axis ``dim`` so that head h reads group h // (H / G)."""
    return t.repeat_interleave(heads // t.shape[dim], dim=dim)


def ssd_chunk_ref(xdt, la, b, c, h0=None):
    """The sequential recurrence, one step at a time."""
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    bh, ch = _per_head(b, h, 2), _per_head(c, h, 2)
    state = h0 if h0 is not None else torch.zeros((bsz, h, p, n), dtype=xdt.dtype,
                                                  device=xdt.device)
    ys = []
    for t in range(s):
        state = torch.exp(la[:, t])[..., None, None] * state \
            + xdt[:, t, :, :, None] * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], state))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xdt)
    return y, state


def ssd_chunk_plain(xdt, la, b, c, chunk: int, h0=None):
    """The chunked SSD scan; ``chunk`` divides S."""
    bsz, s, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunk_plain: chunk {chunk} does not divide S = {s}")
    nc = s // chunk
    cum = la.reshape(bsz, nc, chunk, h).cumsum(dim=2)               # [B,nc,Q,H]
    xr = xdt.reshape(bsz, nc, chunk, h, p)
    br = b.reshape(bsz, nc, chunk, g, n)
    cr = c.reshape(bsz, nc, chunk, g, n)

    # Intra-chunk (quadratic).
    scores = _per_head(torch.einsum("bcqgn,bckgn->bcgqk", cr, br), h, 2)  # [B,nc,H,Q,Q]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]               # cum_q - cum_k
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=xdt.device).tril()
    l_mat = torch.exp(torch.where(causal[None, None, :, :, None], seg, -torch.inf))
    att = scores * l_mat.permute(0, 1, 4, 2, 3)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", att, xr)

    # Per-chunk state contributions and the inter-chunk recurrence.
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)                    # [B,nc,Q,H]
    chunk_states = torch.einsum("bckhn,bckhp->bchpn", _per_head(br, h, 3),
                                xr * decay_end[..., None])           # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[:, :, -1, :])                         # [B,nc,H]
    state = h0 if h0 is not None else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                                  device=xdt.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_states[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)                              # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", _per_head(cr, h, 3), h_prev) \
        * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(bsz, s, h, p), state
