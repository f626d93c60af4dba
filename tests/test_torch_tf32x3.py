"""A plain-torch model of the 3xTF32 arithmetic of the tensor-core kernels of
B1 (``rolann_stats/csrc/rolann_stats_sm90.cuh``, one tenant, m > 28), B10
(``ssd_chunk/csrc/ssd_chunk.cu``), its backward B10ᵇ
(``ssd_chunk/csrc/ssd_chunk_bwd.cu``) and the float32 routes of B7 and B8
(``flash_attention/csrc/flash_attention.cu``, ``flash_attention_bwd.cu``;
their model is ``tests/_flash_emulation.py``'s ``forward_tf32x3`` and
``backward_tf32x3`` on this file's ``mm``), held on the CPU to the port's
plain versions under the card's unchanged bars: B1's G and M within 1e-4
of their largest magnitude, B10's y and h_final within 1e-5 of
max|plain|, B10ᵇ's dxdt, dB and dC within 1e-4 of max|plain| and each
element of its dla within 1e-5 of its term magnitude, B7's out within 1e-5
of max(1, max|ref|) and lse within 1e-5 of max|lse|, each element of B8's
dq, dk and dv within 1e-5 of its term magnitude.

What it models:

* ``cvt.rna.tf32.f32``: a float32 rounded to TF32 (10 stored mantissa
  bits) half away from zero, on the bit pattern: add half of the 13
  dropped bits, clear them.
* The split of a float32 operand x into hi = rna(x) and lo = rna(x - hi)
  (x - hi is exact in float32), so that hi + lo carries x to ~2^-22 of
  itself where hi alone errs by up to 2^-11.
* ``wgmma ... m64nNk8 .tf32``: each product taken in 8-deep steps, each
  step summed exactly (float64 holds a sum of 8 products of TF32 values
  exactly enough) and added to the float32 accumulator rounding toward
  zero, as the tensor cores add (an H100's B1 at n = 10,007 in one
  accumulator came out 1.2e-4 of max|G| below its plain version on
  all-positive terms; rounding to nearest would leave no drift); per step
  the kernels issue lo·hi, then hi·lo, then hi·hi.  ``split3=False`` is
  the single-TF32 variant (one product of rna-rounded operands), which the
  kernels do not use.
* Everything else in float32 as the kernels do it: B1's slices of at most
  2,048 samples as the wrapper plans them (``ops.plan_slices_tf32x3``, for
  an H100's 132 SMs) summed in slice order, M on FP32 FMAs in sample order;
  B10's cumulative sums, decays, masks and the state pass; B10ᵇ's per-group
  scores, chunk sums by 32-step stages and tile products, each in a fresh
  accumulator added in float32, its state passes and dla's crossing sums
  (``ssd_chunk_bwd_model``); B7's online
  softmax over its key tiles; B8's tile products each taken in a fresh
  accumulator and added in float32 (summed in one accumulator over
  thousands of steps, the rounding toward zero drifts past B8's bar).

Run as a script, it prints the share of each bar that the model uses, for
both variants, at the cases the tests use:

    PYTHONPATH=src python tests/test_torch_tf32x3.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.rolann_stats import ops as stats_ops
from repro_torch.kernels.rolann_stats import rolann_stats_plain
from repro_torch.kernels.ssd_chunk import fit_chunk, ssd_chunk_bwd_plain, ssd_chunk_plain
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_magnitudes

K_STEP = 8       # depth of one TF32 wgmma
H100_SMS = 132
B10_TILE = 64    # query and key rows of B10's tiles


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the float32 value of its TF32 rounding, half away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(x)
    return hi, rna_tf32(x.float() - hi)


def mm(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None, *,
       split3: bool = True) -> torch.Tensor:
    """acc + a [..., M, K] @ b [..., K, N] as the kernels' wgmmas take it:
    8-deep steps, each summed exactly into a float32 accumulator; lo·hi,
    hi·lo, hi·hi per step (``split3``), or one rna-rounded product."""
    a, b = a.float(), b.float()
    if acc is None:
        acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    if split3:
        (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    else:
        terms = ((rna_tf32(a), rna_tf32(b)),)
    for k in range(0, a.shape[-1], K_STEP):
        for x, y in terms:
            step = x[..., k:k + K_STEP].double() @ y[..., k:k + K_STEP, :].double()
            acc = round_toward_zero(acc.double() + step)
    return acc


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def fma_seq(acc: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """acc + Σ_k x[..., k]·y[..., k] by FP32 FMAs in k order (one rounding each)."""
    for k in range(x.shape[-1]):
        acc = (acc.double() + x[..., k].double() * y[..., k].double()).float()
    return acc


# ---- B1 ----

def rolann_stats_model(xa, fsq, fd, *, split3=True):
    """B1's (G [o, m, m], M [o, m]) as the tensor-core route forms them: per
    slice A = fl32(xa_i·fsq[o]) against B = xa_j over the slice's samples and
    M on FP32 FMAs, the slices summed in order; the upper triangle mirrored."""
    xa, fsq, fd = xa.float(), fsq.float(), fd.float()
    (m, n), o = xa.shape, fsq.shape[0]
    _, slice_len = stats_ops.plan_slices_tf32x3(m, n, o, H100_SMS)
    full, mv = torch.zeros((o, m, m)), torch.zeros((o, m))
    for k0 in range(0, n, slice_len):
        x, f, d = xa[:, k0:k0 + slice_len], fsq[:, k0:k0 + slice_len], fd[:, k0:k0 + slice_len]
        full = full + mm(x[None] * f[:, None, :], x.T[None], split3=split3)   # [o, m, m]
        mv = mv + fma_seq(torch.zeros((o, m)), x[None], d[:, None, :])
    g = full.triu() + full.triu(1).transpose(1, 2)
    return g, mv


def _stats_inputs(m, o, n, seed):
    """As chip_smoke.py's: xa = [sigmoid(z); 1], fsq in (0, 1/16], fd = fsq·2z'."""
    rng = np.random.default_rng(seed)
    xa = 1.0 / (1.0 + np.exp(-rng.normal(size=(m, n))))
    xa[-1] = 1.0
    fsq = rng.random((o, n)) / 16.0
    fd = fsq * rng.normal(size=(o, n)) * 2.0
    return tuple(torch.from_numpy(t.astype(np.float32)) for t in (xa, fsq, fd))


def rolann_stats_share(m, o, n, seed, split3=True):
    """The largest share of B1's bar (1e-4·max|plain|) G or M uses."""
    xa, fsq, fd = _stats_inputs(m, o, n, seed)
    g, mv = rolann_stats_model(xa, fsq, fd, split3=split3)
    gp, mp = rolann_stats_plain(xa, fsq, fd)
    assert torch.equal(g, g.transpose(1, 2))
    return max(float((g.double() - gp.double()).abs().max() / (1e-4 * gp.abs().max())),
               float((mv.double() - mp.double()).abs().max() / (1e-4 * mp.abs().max())))


# (m, o, n): a ragged tile past the one-warp layout's 28, a ragged n, one
# slice of the DAEF head's shape (513, 256, 2,048): 4 of its 256 outputs,
# and n = 10,007 in slices of at most 2,048.
B1_CASES = [(29, 3, 7), (65, 2, 301), (130, 3, 1_003), (513, 4, 2_048), (129, 1, 10_007)]


# ---- B10 ----

def ssd_chunk_model(xdt, la, b, c, chunk, *, split3=True):
    """B10's (y, h_final) as the tensor-core kernels form them, per (b, h):
    the chunk states (xdt·decay_end)ᵀ·B over the chunk's steps, the float32
    state pass, then per 64-row query tile the inter term C·h_prevᵀ over N
    scaled by exp(cum_i), and the intra term over the key tiles up to the
    diagonal: S = C·Bᵀ over N, P = S·exp(cum_i - cum_j) masked, P·xdt."""
    bsz, s, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    y = torch.zeros((bsz, s, h, p))
    h_final = torch.zeros((bsz, h, p, n))
    for bi in range(bsz):
        for hi in range(h):
            gi = hi // (h // g)
            state = torch.zeros((p, n))
            for ci in range(nc):
                rows = slice(ci * chunk, (ci + 1) * chunk)
                cum = torch.cumsum(la[bi, rows, hi].float(), 0)
                x = xdt[bi, rows, hi].float()                   # [Q, P]
                bm, cm = b[bi, rows, gi].float(), c[bi, rows, gi].float()   # [Q, N]
                contrib = mm((x * torch.exp(cum[-1] - cum)[:, None]).T, bm, split3=split3)
                h_prev = state
                state = (state.double() * float(torch.exp(cum[-1])) + contrib.double()).float()
                for i0 in range(0, chunk, B10_TILE):
                    ci_rows = slice(i0, min(i0 + B10_TILE, chunk))
                    acc = mm(cm[ci_rows], h_prev.T, split3=split3)
                    acc = acc * torch.exp(cum[ci_rows])[:, None]
                    for j0 in range(0, i0 + 1, B10_TILE):
                        cj = slice(j0, min(j0 + B10_TILE, chunk))
                        sc = mm(cm[ci_rows], bm[cj].T, split3=split3)
                        ti = torch.arange(ci_rows.start, ci_rows.stop)[:, None]
                        tj = torch.arange(cj.start, cj.stop)[None, :]
                        dec = torch.exp(cum[ci_rows][:, None] - cum[cj][None, :])
                        pm = torch.where(tj <= ti, sc * dec, torch.zeros(()))
                        acc = mm(pm, x[cj], acc, split3=split3)
                    y[bi, ci * chunk + ci_rows.start:ci * chunk + ci_rows.stop, hi] = acc
            h_final[bi, hi] = state
    return y, h_final


def _ssd_inputs(b, s, h, p, g, n, seed):
    """As chip_smoke.py's: xdt, B, C standard normal, la in [-0.1, 0]."""
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(b, s, h, p))
    la = -rng.random((b, s, h)) * 0.1
    bm, cm = rng.normal(size=(b, s, g, n)), rng.normal(size=(b, s, g, n))
    return tuple(torch.from_numpy(t.astype(np.float32)) for t in (xdt, la, bm, cm))


def ssd_chunk_share(b, s, h, p, g, n, chunk, seed, split3=True):
    """The largest share of B10's bar (1e-5·max|plain|) y or h_final uses."""
    xdt, la, bm, cm = _ssd_inputs(b, s, h, p, g, n, seed)
    q = fit_chunk(s, chunk)
    y, hf = ssd_chunk_model(xdt, la, bm, cm, q, split3=split3)
    yr, hr = ssd_chunk_plain(xdt, la, bm, cm, q)
    return max(float((y.double() - yr.double()).abs().max() / (1e-5 * yr.abs().max())),
               float((hf.double() - hr.double()).abs().max() / (1e-5 * hr.abs().max())))


# (b, s, h, p, g, n, chunk): small heads, a ragged chunk (250 -> 50, not a
# multiple of 8), two groups, and one (b, h) of mamba2-780m (P 64, N 128,
# chunk 256) at S = 512.
B10_CASES = [(1, 64, 2, 16, 1, 32, 32), (1, 250, 2, 16, 1, 32, 64), (1, 128, 4, 8, 2, 24, 64),
             (1, 512, 1, 64, 1, 128, 256)]


# ---- B10's backward ----

def _exp32(d: torch.Tensor) -> torch.Tensor:
    """expf of a float64 difference rounded to float32, as the kernels take
    every decay."""
    return torch.exp(d.float())


def _fma32(acc, w, x):
    """acc + w·x with one rounding (an FP32 FMA)."""
    return (acc.double() + w.double() * x.double()).float()


def ssd_chunk_bwd_model(xdt, la, b, c, dy, dh_final, chunk, *, split3=True):
    """B10's backward ``(dxdt, dla, db, dc)`` as its tensor-core kernels form
    it, per batch row and chunk with the heads batched: S = C·Bᵀ and Sᵀ =
    B·Cᵀ once per group and 64 x 64 tile pair (one accumulator over N); the
    chunk sums by stages of 32 steps, each stage's product in a fresh
    accumulator added in float32; the float32 state passes (FMAs); per key
    tile dxdt = Σ over the query tiles of (Sᵀ ∘ L)·dy and dB = Σ of
    (L ∘ xdt·dyᵀ)·C, per query tile dC = Σ over the key tiles of
    (L ∘ dy·xdtᵀ)·B, each tile's product in a fresh accumulator added in
    float32, then the state terms (B·Dᵀ, xdt·D, dy·h_prev over N or P, one
    product each) added with the weights by FMAs; M = (S ∘ L) ∘ (dy·xdtᵀ) in
    float32 and dla from its crossing sums (each row's exclusive prefix over
    the keys, summed in order), I's suffix and S's prefix sums and
    exp(cum_last)·<D, h_prev>, all float32."""
    bsz, s, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    nc, tq = s // chunk, -(-chunk // B10_TILE)
    hg = torch.arange(h) // (h // g)     # the group of each head
    tiles = [slice(t * B10_TILE, min((t + 1) * B10_TILE, chunk)) for t in range(tq)]
    kw = dict(split3=split3)
    dxdt, dla = torch.zeros((bsz, s, h, p)), torch.zeros((bsz, s, h))
    dbh, dch = torch.zeros((bsz, s, h, n)), torch.zeros((bsz, s, h, n))
    for bi in range(bsz):
        per = []  # per chunk: cum [Q, H], x, y [H, Q, P], bh, chh [H, Q, N], bg, cg [G, Q, N]
        sums = []
        for ci in range(nc):
            rows = slice(ci * chunk, (ci + 1) * chunk)
            cum = la[bi, rows].double().cumsum(0)
            x, y = (t[bi, rows].float().permute(1, 0, 2) for t in (xdt, dy))
            bg, cg = (t[bi, rows].float().permute(1, 0, 2) for t in (b, c))
            per.append((cum, x, y, bg[hg], cg[hg], bg, cg))
            w_end, w_in = _exp32(cum[-1] - cum).T, _exp32(cum).T      # [H, Q]
            contrib, e_c = torch.zeros((h, p, n)), torch.zeros((h, p, n))
            for j0 in range(0, chunk, 32):
                st = slice(j0, min(j0 + 32, chunk))
                contrib = contrib + mm((x[:, st] * w_end[:, st, None]).transpose(1, 2),
                                       bg[hg][:, st], **kw)
                e_c = e_c + mm((y[:, st] * w_in[:, st, None]).transpose(1, 2),
                               cg[hg][:, st], **kw)
            sums.append((contrib, e_c, _exp32(cum[-1])))
        state = torch.zeros((h, p, n))
        grad = torch.zeros((h, p, n)) if dh_final is None else dh_final[bi].float()
        h_prev, d_out = [None] * nc, [None] * nc
        for ci in range(nc):
            h_prev[ci] = state
            state = _fma32(sums[ci][0], state, sums[ci][2][:, None, None])
        for ci in reversed(range(nc)):
            d_out[ci] = grad
            grad = _fma32(sums[ci][1], grad, sums[ci][2][:, None, None])
        for ci in range(nc):
            cum, x, y, bh, chh, bg, cg = per[ci]
            hp, dd_state, cd = h_prev[ci], d_out[ci], sums[ci][2]
            w_end, w_in = _exp32(cum[-1] - cum).T, _exp32(cum).T
            t_idx = torch.arange(chunk)

            def decay(qs, ks):  # L [H, len(qs), len(ks)] for k <= q
                d = _exp32(cum[qs][:, None, :] - cum[ks][None, :, :]).permute(2, 0, 1)
                return torch.where((t_idx[ks][None, :] <= t_idx[qs][:, None])[None], d,
                                   torch.zeros(()))

            m_full = torch.zeros((h, chunk, chunk))
            rows_out = slice(ci * chunk, (ci + 1) * chunk)
            s_term, i_term = torch.zeros((h, chunk)), torch.zeros((h, chunk))
            for kt, ks in enumerate(tiles):     # the key tiles: dxdt, dB, S_k
                tot_x, tot_b = torch.zeros((h, ks.stop - ks.start, p)), \
                    torch.zeros((h, ks.stop - ks.start, n))
                for qs in tiles[kt:]:
                    l_kq = decay(qs, ks).transpose(1, 2)          # [H, k, q]
                    st_t = mm(bg[:, ks], cg[:, qs].transpose(1, 2), **kw)[hg]
                    tot_x = tot_x + mm(st_t * l_kq, y[:, qs], **kw)
                    dd_t = mm(x[:, ks], y[:, qs].transpose(1, 2), **kw)
                    tot_b = tot_b + mm(l_kq * dd_t, chh[:, qs], **kw)
                part_x = mm(bh[:, ks], dd_state.transpose(1, 2), **kw)
                part_b = mm(x[:, ks], dd_state, **kw)
                w = w_end[:, ks, None]
                dxdt[bi, ci * chunk + ks.start:ci * chunk + ks.stop] = \
                    _fma32(tot_x, w, part_x).permute(1, 0, 2)
                dbh[bi, ci * chunk + ks.start:ci * chunk + ks.stop] = \
                    _fma32(tot_b, w, part_b).permute(1, 0, 2)
                s_term[:, ks] = w[..., 0] * (bh[:, ks].double() * part_b.double()).sum(-1).float()
            for qt, qs in enumerate(tiles):     # the query tiles: dC, M, I_q
                tot_c = torch.zeros((h, qs.stop - qs.start, n))
                for ks in tiles[:qt + 1]:
                    l_qk = decay(qs, ks)
                    s_qk = mm(cg[:, qs], bg[:, ks].transpose(1, 2), **kw)[hg]
                    dd_q = mm(y[:, qs], x[:, ks].transpose(1, 2), **kw)
                    m_full[:, qs, ks] = (s_qk * l_qk) * dd_q
                    tot_c = tot_c + mm(l_qk * dd_q, bh[:, ks], **kw)
                part_c = mm(y[:, qs], hp, **kw)
                w = w_in[:, qs, None]
                dch[bi, ci * chunk + qs.start:ci * chunk + qs.stop] = \
                    _fma32(tot_c, w, part_c).permute(1, 0, 2)
                i_term[:, qs] = w[..., 0] * (chh[:, qs].double() * part_c.double()).sum(-1).float()
            prefix = torch.nn.functional.pad(m_full[..., :-1], (1, 0)).cumsum(-1)
            crossing = (prefix * (t_idx[:, None] >= t_idx[None, :])).sum(-2)   # [H, Q]
            suffix = i_term.flip(-1).cumsum(-1).flip(-1)
            s_prefix = torch.nn.functional.pad(s_term[:, :-1], (1, 0)).cumsum(-1)
            extra = cd * (dd_state.double() * hp.double()).sum((-2, -1)).float()
            dla[bi, rows_out] = (crossing + suffix + s_prefix + extra[:, None]).T
    db = dbh.reshape(bsz, s, g, h // g, n).sum(3)
    dc = dch.reshape(bsz, s, g, h // g, n).sum(3)
    return dxdt, dla, db, dc


def _ssd_bwd_inputs(b, s, h, p, g, n, final, decays, seed):
    """As chip_smoke.py's: xdt, B, C, dy, dh_final standard normal; la in
    [-0.1, 0], or (``decays``) mamba2's initial -a·softplus(z), a =
    linspace(1, 16, H), whose cum reaches -10³ within a chunk."""
    rng = np.random.default_rng(seed)
    xdt, dy = rng.normal(size=(b, s, h, p)), rng.normal(size=(b, s, h, p))
    if decays:
        la = -np.linspace(1.0, 16.0, h) * np.log1p(np.exp(rng.normal(size=(b, s, h))))
    else:
        la = -rng.random((b, s, h)) * 0.1
    bm, cm = rng.normal(size=(b, s, g, n)), rng.normal(size=(b, s, g, n))
    dh = rng.normal(size=(b, h, p, n)) if final else None
    return tuple(None if t is None else torch.from_numpy(t.astype(np.float32))
                 for t in (xdt, la, bm, cm, dy, dh))


def ssd_chunk_bwd_shares(b, s, h, p, g, n, chunk, final, decays, seed, split3=True):
    """The shares of B10ᵇ's bars the model uses: dxdt, dB, dC each against
    1e-4·max|plain|, dla per element against 1e-5 of its term magnitude."""
    args = _ssd_bwd_inputs(b, s, h, p, g, n, final, decays, seed)
    q = fit_chunk(s, chunk)
    got = ssd_chunk_bwd_model(*args, q, split3=split3)
    want = ssd_chunk_bwd_plain(*args, chunk=q)
    mags = ssd_chunk_bwd_magnitudes(*args, chunk=q)
    shares = {name: float((gt.double() - wt.double()).abs().max() / (1e-4 * wt.abs().max()))
              for name, gt, wt in zip(("dxdt", "db", "dc"), (got[0], *got[2:]),
                                      (want[0], *want[2:]))}
    shares["dla"] = float(((got[1].double() - want[1].double()).abs()
                           / (1e-5 * mags[1].double()).clamp_min(1e-300)).max())
    return shares


# (b, s, h, p, g, n, chunk, h_final cotangent, mamba2's decays): one group,
# two groups at a ragged chunk (250, not a multiple of 64 or 8), a nonzero
# h_final cotangent, and decays whose cum reaches -10³ within a chunk.
B10_BWD_CASES = [(1, 128, 2, 16, 1, 32, 64, False, False),
                 (1, 250, 4, 8, 2, 16, 256, True, False),
                 (2, 128, 2, 16, 1, 32, 128, True, False),
                 (1, 256, 4, 8, 1, 16, 128, True, True)]


# ---- B7 and B8, the float32 route ----

# (Sq, Sk, H, Hkv, D, D_v, causal, window, q_offset): the five head-size
# pairs, causal and not, windows 17 and 1, MQA, ragged S (no multiple of the
# key tiles) and a q_offset stripe.
FLASH_CASES = [
    (100, 100, 4, 2, 32, 32, True, 17, 0),
    (97, 97, 4, 1, 64, 64, False, None, 0),
    (77, 77, 2, 2, 128, 128, True, 1, 0),
    (70, 70, 2, 1, 256, 256, True, None, 0),
    (90, 90, 2, 2, 192, 128, True, None, 0),
    (50, 50, 2, 1, 192, 128, False, None, 0),
    (40, 160, 4, 2, 128, 128, True, None, 96),
]


def flash_shares(sq, sk, h, hkv, d, d_v, causal, window, q_offset, split3=True):
    """(B7 out, B7 lse, B8) shares of their bars in the model."""
    import _flash_emulation as emulation

    q, k, v, do = emulation.inputs_f32(sq, h, hkv, d, seed=sq + d, d_v=d_v, sk=sk)
    return emulation.tf32x3_shares(q, k, v, do, causal=causal, window=window,
                                   q_offset=q_offset, split3=split3)


# ---- tests ----

@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),            # a tie rounds away from zero
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),            # below the tie
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 5 * 2.0**-11, 1.0 + 3 * 2.0**-10),    # a tie above an even ulp: away, not even
    (2.0**-130, 2.0**-130),                      # a subnormal keeps its top bits
])
def test_rna_rounds_half_away_from_zero(x, want):
    assert float(rna_tf32(torch.tensor([x], dtype=torch.float32))) == want


def test_split_carries_float32_to_2_22():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=10_000).astype(np.float32))
    hi, lo = split(x)
    assert bool((rna_tf32(hi) == hi).all() and (rna_tf32(lo) == lo).all())
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0**-11
    assert float(((x.double() - hi.double() - lo.double()).abs() / x.double().abs()).max()) \
        <= 2.0**-21


@pytest.mark.parametrize("m,o,n", B1_CASES)
def test_rolann_stats_model_holds_the_bar(m, o, n):
    share = rolann_stats_share(m, o, n, seed=m + n)
    single = rolann_stats_share(m, o, n, seed=m + n, split3=False)
    print(f"B1 m={m} o={o} n={n}: 3xTF32 uses {share:.4f} of the bar, one TF32 {single:.4f}")
    assert share <= 1.0
    assert share < single


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", B10_CASES)
def test_ssd_chunk_model_holds_the_bar(b, s, h, p, g, n, chunk):
    share = ssd_chunk_share(b, s, h, p, g, n, chunk, seed=s + n)
    single = ssd_chunk_share(b, s, h, p, g, n, chunk, seed=s + n, split3=False)
    print(f"B10 B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk}: 3xTF32 uses "
          f"{share:.4f} of the bar, one TF32 {single:.4f}")
    assert share <= 1.0
    assert share < single


@pytest.mark.parametrize("case", B10_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_chunk_bwd_model_holds_the_bars(case):
    shares = ssd_chunk_bwd_shares(*case, seed=case[1] + case[5])
    print(f"B10ᵇ {case}: 3xTF32 uses " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
          + " of the bars")
    assert max(shares.values()) <= 1.0


def test_ssd_chunk_bwd_single_tf32_misses_the_bars():
    """One TF32 product of rna-rounded operands misses B10ᵇ's bars."""
    case = B10_BWD_CASES[0]
    shares = ssd_chunk_bwd_shares(*case, seed=case[1] + case[5], split3=False)
    print(f"B10ᵇ {case}: one TF32 uses {shares} of the bars")
    assert min(shares.values()) > 1.0


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_tf32x3_model_holds_the_bars(case):
    share_out, share_lse, share_bwd = flash_shares(*case)
    print(f"B7/B8 {case}: 3xTF32 uses {share_out:.4f} (out), {share_lse:.4f} (lse), "
          f"{share_bwd:.4f} (dq, dk, dv) of the bars")
    assert max(share_out, share_lse, share_bwd) <= 1.0


def test_flash_single_tf32_misses_the_bars():
    """One TF32 product of rna-rounded operands misses every bar: the bars
    tell the split from the rounding."""
    shares = flash_shares(*FLASH_CASES[2], split3=False)
    print(f"B7/B8 {FLASH_CASES[2]}: one TF32 uses {shares} of the bars")
    assert min(shares) > 1.0


if __name__ == "__main__":
    for m, o, n in B1_CASES:
        print(f"B1 m={m} o={o} n={n}: share of the bar 3xTF32 "
              f"{rolann_stats_share(m, o, n, m + n):.4f}, one TF32 "
              f"{rolann_stats_share(m, o, n, m + n, split3=False):.4f}")
    for case in B10_CASES:
        seed = case[1] + case[5]
        print(f"B10 (B, S, H, P, G, N, chunk) = {case}: share of the bar 3xTF32 "
              f"{ssd_chunk_share(*case, seed):.4f}, one TF32 "
              f"{ssd_chunk_share(*case, seed, split3=False):.4f}")
    for case in B10_BWD_CASES:
        print(f"B10ᵇ {case}: shares of the bars 3xTF32 "
              f"{ssd_chunk_bwd_shares(*case, seed=case[1] + case[5])}, one TF32 "
              f"{ssd_chunk_bwd_shares(*case, seed=case[1] + case[5], split3=False)}")
    for case in FLASH_CASES:
        print(f"B7/B8 {case}: shares of the bars (out, lse, dq/dk/dv) 3xTF32 "
              f"{flash_shares(*case)}, one TF32 {flash_shares(*case, split3=False)}")
