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
  held against it on the card.  The within-chunk cumulative sum of la is
  taken in float64 (the reference's is float32): at mamba2's decays it
  reaches -10³ within a chunk, where the difference of two float32 sums
  keeps only ~1e-4 of exp(cum_q - cum_k), and the card and the host,
  summing in other orders, then drift apart by that much.
* :func:`ssd_chunk_bwd_plain` — the backward of the chunked scan written
  out in torch operations (no autograd): the B10 backward kernel
  (``csrc/ssd_chunk_bwd.cu``) computes this function and is held against
  it on the card; the wrapper runs it for CPU tensors.
  :func:`ssd_chunk_bwd_magnitudes` gives the size of each output's terms,
  the scale of the card's per-element bar on dla.
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
    dtype = xdt.dtype
    cum = la.double().reshape(bsz, nc, chunk, h).cumsum(dim=2)      # [B,nc,Q,H]
    xr = xdt.reshape(bsz, nc, chunk, h, p)
    br = b.reshape(bsz, nc, chunk, g, n)
    cr = c.reshape(bsz, nc, chunk, g, n)

    # Intra-chunk (quadratic).
    scores = _per_head(torch.einsum("bcqgn,bckgn->bcgqk", cr, br), h, 2)  # [B,nc,H,Q,Q]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]               # cum_q - cum_k
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=xdt.device).tril()
    l_mat = torch.exp(torch.where(causal[None, None, :, :, None], seg, -torch.inf)).to(dtype)
    att = scores * l_mat.permute(0, 1, 4, 2, 3)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", att, xr)

    # Per-chunk state contributions and the inter-chunk recurrence.
    decay_end = torch.exp(cum[:, :, -1:, :] - cum).to(dtype)          # [B,nc,Q,H]
    chunk_states = torch.einsum("bckhn,bckhp->bchpn", _per_head(br, h, 3),
                                xr * decay_end[..., None])           # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[:, :, -1, :]).to(dtype)               # [B,nc,H]
    state = h0 if h0 is not None else torch.zeros((bsz, h, p, n), dtype=xdt.dtype,
                                                  device=xdt.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_states[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)                              # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", _per_head(cr, h, 3), h_prev) \
        * torch.exp(cum).to(dtype)[..., None]
    return (y_intra + y_inter).reshape(bsz, s, h, p), state


def _exclusive_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ of the entries before each one along ``dim``, summed in order."""
    shifted = t.narrow(dim, 0, t.shape[dim] - 1)
    pad = [0, 0] * (t.ndim - 1 - dim % t.ndim) + [1, 0]
    return torch.nn.functional.pad(shifted, pad).cumsum(dim)


def _group_sum(t: torch.Tensor, groups: int, dim: int) -> torch.Tensor:
    """Sum a per-head axis ``dim`` over the heads of each group (the adjoint
    of :func:`_per_head`)."""
    shape = t.shape
    return t.reshape(*shape[:dim], groups, shape[dim] // groups, *shape[dim + 1:]).sum(dim + 1)


def ssd_chunk_bwd_plain(xdt, la, b, c, dy, dh_final=None, *, chunk: int):
    """The backward of :func:`ssd_chunk_plain` (from h0 = 0) for the output
    cotangents dy [B, S, H, P] and ``dh_final`` [B, H, P, N] (``None``:
    zero): ``(dxdt, dla, db, dc)`` in the inputs' shapes, db and dc summed
    over the heads of each group.

    Per chunk, with cum the within-chunk cumulative sum of la, L[q, k] =
    exp(cum_q - cum_k) for q >= k, s[q, k] = C_q·B_k, h_prev the state that
    enters the chunk and D the gradient of the state that leaves it (the
    reverse pass D_{c-1} = exp(cum_last_c) D_c + Σ_q exp(cum_q) dy_q ⊗ C_q
    from D_last = dh_final):

        dxdt_k = Σ_{q>=k} s L dy_q + exp(cum_last - cum_k) D B_k
        dB_k   = Σ_{q>=k} L (dy_q·xdt_k) C_q + exp(cum_last - cum_k) Dᵀ xdt_k
        dC_q   = Σ_{k<=q} L (dy_q·xdt_k) B_k + exp(cum_q) h_prevᵀ dy_q
        dla_t  = Σ_{q>=t, k<t} M[q, k] + Σ_{q>=t} I_q + Σ_{k<t} S_k
                 + exp(cum_last) <D, h_prev>

    with M[q, k] = s L (dy_q·xdt_k), I_q = exp(cum_q) C_q·(h_prevᵀ dy_q) and
    S_k = exp(cum_last - cum_k) B_k·(Dᵀ xdt_k).  dla is the reverse
    cumulative sum of dcum (the row sums of M minus its column sums, plus
    I_q, minus S_k, plus the last step's state terms), summed here as the
    pairs that cross t: the row and column sums, each as large as M's terms,
    would cancel.  cum is summed in float64: within a chunk it reaches -10³
    at mamba2's initial decays (a·dt up to ~11 a step), and the difference
    of two float32 sums that size keeps ~1e-4 of exp(cum_q - cum_k)."""
    return _ssd_bwd(xdt, la, b, c, dy, dh_final, chunk)


def ssd_chunk_bwd_magnitudes(xdt, la, b, c, dy, dh_final=None, *, chunk: int):
    """Each output element of :func:`ssd_chunk_bwd_plain` as the sum of the
    absolute values of the terms that make it: the same function of |xdt|,
    |b|, |c|, |dy| and |dh_final|.  Two float32 evaluations of the backward
    in other orders differ by a small multiple of eps times this (the bar of
    dla, whose terms have both signs)."""
    return _ssd_bwd(xdt.abs(), la, b.abs(), c.abs(), dy.abs(),
                    None if dh_final is None else dh_final.abs(), chunk)


def _ssd_bwd(xdt, la, b, c, dy, dh_final, chunk):
    bsz, s, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunk_bwd: chunk {chunk} does not divide S = {s}")
    nc = s // chunk
    dtype, dev = xdt.dtype, xdt.device
    cum = la.double().reshape(bsz, nc, chunk, h).cumsum(dim=2)      # [B,nc,Q,H]
    xr = xdt.reshape(bsz, nc, chunk, h, p)
    dyr = dy.reshape(bsz, nc, chunk, h, p)
    brep = _per_head(b.reshape(bsz, nc, chunk, g, n), h, 3)         # [B,nc,Q,H,N]
    crep = _per_head(c.reshape(bsz, nc, chunk, g, n), h, 3)

    # The states entering each chunk, as the forward computes them.
    decay_end = torch.exp(cum[:, :, -1:, :] - cum).to(dtype)         # [B,nc,Q,H]
    decay_in = torch.exp(cum).to(dtype)                               # [B,nc,Q,H]
    chunk_decay = torch.exp(cum[:, :, -1, :]).to(dtype)               # [B,nc,H]
    chunk_states = torch.einsum("bckhn,bckhp->bchpn", brep, xr * decay_end[..., None])
    inter_src = torch.einsum("bcqhn,bcqhp->bchpn", crep, dyr * decay_in[..., None])
    state = torch.zeros((bsz, h, p, n), dtype=dtype, device=dev)
    grad = state.clone() if dh_final is None else dh_final.to(dtype)
    h_prevs, grads = [], [None] * nc
    for ci in range(nc):
        h_prevs.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_states[:, ci]
    for ci in reversed(range(nc)):
        grads[ci] = grad
        grad = grad * chunk_decay[:, ci, :, None, None] + inter_src[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)                              # [B,nc,H,P,N]
    d_out = torch.stack(grads, dim=1)                                 # [B,nc,H,P,N]

    # The intra-chunk terms.
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(0, 1, 4, 2, 3)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    l_mat = torch.exp(torch.where(causal, seg, -torch.inf)).to(dtype)  # [B,nc,H,Q,Q]
    scores = _per_head(torch.einsum("bcqgn,bckgn->bcgqk",
                                    c.reshape(bsz, nc, chunk, g, n),
                                    b.reshape(bsz, nc, chunk, g, n)), h, 2)
    dyx = torch.einsum("bcqhp,bckhp->bchqk", dyr, xr)                # dy_q·xdt_k
    att = scores * l_mat
    w_mat = l_mat * dyx
    m_mat = att * dyx

    # The state terms.
    d_b = torch.einsum("bchpn,bckhn->bckhp", d_out, brep)            # D B_k
    d_x = torch.einsum("bchpn,bckhp->bckhn", d_out, xr)              # Dᵀ xdt_k
    hp_dy = torch.einsum("bchpn,bcqhp->bcqhn", h_prev, dyr)          # h_prevᵀ dy_q

    dxdt = torch.einsum("bchqk,bcqhp->bckhp", att, dyr) + decay_end[..., None] * d_b
    db = torch.einsum("bchqk,bcqhn->bckhn", w_mat, crep) + decay_end[..., None] * d_x
    dc = torch.einsum("bchqk,bckhn->bcqhn", w_mat, brep) + decay_in[..., None] * hp_dy

    # dla_t: the pairs (q >= t, k < t) of M, I_q over q >= t, S_k over k < t;
    # the exclusive prefixes summed from the left, not as an inclusive sum
    # minus its last term (at mamba2's decays the diagonal term is ~1e8 times
    # the prefix before it, which that difference loses)
    crossing = (_exclusive_cumsum(m_mat, -1) * causal).sum(-2)      # [B,nc,H,Q]
    inter = decay_in * (hp_dy * crep).sum(-1)                         # I_q [B,nc,Q,H]
    state_term = decay_end * (d_x * brep).sum(-1)                     # S_k [B,nc,Q,H]
    dla = (crossing.permute(0, 1, 3, 2) + inter.flip(2).cumsum(2).flip(2)
           + _exclusive_cumsum(state_term, 2)
           + (chunk_decay * (d_out * h_prev).sum((-2, -1)))[:, :, None])
    return (dxdt.reshape(bsz, s, h, p), dla.reshape(bsz, s, h),
            _group_sum(db, g, 3).reshape(bsz, s, g, n),
            _group_sum(dc, g, 3).reshape(bsz, s, g, n))
