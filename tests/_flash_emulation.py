"""A plain-torch model of the arithmetic of the tensor-core flash-attention
kernels (``csrc/flash_fwd_sm90.cuh``, ``csrc/flash_bwd_sm90.cuh``), for the
CPU tests that hold it to the port's plain versions.

What it models: bf16 operands; every product of a wgmma m64nNk16 taken in
16-deep steps, each step summed exactly and added to a float32 accumulator;
the forward's online softmax over 64-key tiles in float32 (m, l and the
correction of O); and the two derived operands, P (forward, and dV in the
backward) and dS (dQ, dK), entering the tensor cores as a hi + lo pair of
bf16 values, hi = bf16(x), lo = bf16(x - hi), one step of hi then one of lo.
``split=False`` is the single-rounding variant (P and dS rounded once to
bf16), which the kernels do not use.

Both kernels take the causal mask or none (``causal=False``: whisper's
encoder), and head sizes (D, D_v) of q/k and v: equal, or MLA's (192, 128).

The float32 route's kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu`` on ``csrc/flash_tf32x3_sm90.cuh``) are
modelled by :func:`forward_tf32x3` and :func:`backward_tf32x3`: every
product split as the kernels split it (3xTF32: lo·hi + hi·lo + hi·hi per
8-deep step, each step added to the float32 accumulator rounding toward
zero, ``test_torch_tf32x3.mm``), the forward's online softmax over the
kernel's own key tiles (``tf32x3_bk``), and P and dS split as A operands of
the next product in place.  ``split3=False`` is one TF32 product of
rna-rounded operands, which the kernels do not use.

Run as a script, it prints the largest share of its bar that any element
used, for both variants, at the cases the tests use:

    PYTHONPATH=src python tests/_flash_emulation.py
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_magnitudes,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.ref import attention_mask

NEG_INF = -1e30
BK = 64          # keys per tile of the forward's online softmax

# (S, H, Hkv, D, window): head sizes 32 to 256, GQA and MQA, windows 1 and
# 17, ragged S (none is a multiple of 64).
CASES = [
    (150, 4, 2, 32, None),
    (97, 4, 1, 64, 17),
    (77, 4, 2, 128, 1),
    (130, 2, 1, 256, 17),
    (200, 4, 4, 128, None),
]
# (S, H, Hkv, D, D_v, causal): whisper's encoder (no causal mask) and MLA's
# head sizes, ragged S.
NEW_CASES = [
    (150, 4, 4, 64, 64, False),
    (130, 4, 2, 192, 128, True),
    (97, 2, 2, 192, 128, False),
]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] as wgmma accumulates it: K in 16-deep
    steps, each summed exactly (float64 holds any sum of 16 products of
    bf16 values exactly enough) and added to a float32 accumulator."""
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for k in range(0, a.shape[-1], 16):
        acc = acc + (a[..., k:k + 16].double() @ b[..., k:k + 16, :].double()).float()
    return acc


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _mm_derived(x: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """x [..., M, K] float32 (P or dS) @ b [..., K, N] bf16: per 16-deep step
    the hi operand, then the lo one (``split``), or x rounded once."""
    hi = _bf16(x)
    lo = _bf16(x - hi)
    acc = torch.zeros((*x.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for k in range(0, x.shape[-1], 16):
        acc = acc + (hi[..., k:k + 16].double() @ b[..., k:k + 16, :].double()).float()
        if split:
            acc = acc + (lo[..., k:k + 16].double() @ b[..., k:k + 16, :].double()).float()
    return acc


def _heads(x, hkv):
    """[B, S, n, D] -> [B, Hkv, n / Hkv, S, D] float32 (k, v: n = Hkv)."""
    b, s, n, d = x.shape
    return x.float().reshape(b, s, hkv, n // hkv, d).permute(0, 2, 3, 1, 4)


def forward(q, k, v, *, causal=True, window=None, split=True):
    """The forward kernel's (out [B, S, H, D_v] bf16, lse [B, H, S] float32)
    for bf16 q [B, S, H, D], k [B, S, Hkv, D], v [B, S, Hkv, D_v]."""
    b, s, h, d = q.shape
    hkv, scale = k.shape[2], d**-0.5
    qg, kg, vg = _heads(q, hkv), _heads(k, hkv), _heads(v, hkv)
    ok = attention_mask(s, causal, window, q.device)
    m = torch.full(qg.shape[:-1], NEG_INF)
    l = torch.zeros(qg.shape[:-1])
    o = torch.zeros((*qg.shape[:-1], v.shape[-1]))
    for k0 in range(0, s, BK):
        kt, vt = kg[..., k0:k0 + BK, :], vg[..., k0:k0 + BK, :]
        keep = ok[:, k0:k0 + BK]
        x = (_mm(qg, kt.transpose(-1, -2)) * scale).masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None]).masked_fill(~keep, 0.0)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + _mm_derived(p, vt, split)
        m = m_new
    lf = l.clamp_min(1e-30)
    out = (o / lf[..., None]).permute(0, 3, 1, 2, 4).reshape(b, s, h, v.shape[-1])
    return out.to(torch.bfloat16), (m + torch.log(lf)).reshape(b, h, s)


def backward(q, k, v, out, lse, do, *, causal=True, window=None, split=True):
    """The backward kernels' (dq, dk [.., D], dv [.., D_v]) in bf16 for bf16
    q, k, v, dO, the forward's out and float32 lse [B, H, S]."""
    b, s, h, d = q.shape
    hkv, scale = k.shape[2], d**-0.5
    qg, kg, vg, dog = _heads(q, hkv), _heads(k, hkv), _heads(v, hkv), _heads(do, hkv)
    ok = attention_mask(s, causal, window, q.device)
    lse_g = lse.reshape(b, hkv, h // hkv, s)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(lse_g.shape)
    sc = _mm(qg, kg.transpose(-1, -2))
    p = torch.exp(sc * scale - lse_g[..., None]).masked_fill(~ok, 0.0)
    ds = p * (_mm(dog, vg.transpose(-1, -2)) - dvec[..., None])
    dq = scale * _mm_derived(ds, kg, split)
    # dk, dv: the group's query heads one after another into one accumulator.
    dk = torch.zeros(kg.shape[:2] + kg.shape[3:])
    dv = torch.zeros(vg.shape[:2] + vg.shape[3:])
    for g in range(h // hkv):
        dk = dk + _mm_derived(ds[:, :, g].transpose(-1, -2), qg[:, :, g], split)
        dv = dv + _mm_derived(p[:, :, g].transpose(-1, -2), dog[:, :, g], split)

    def ungroup(x, n):
        return x.reshape(b, n, s, x.shape[-1]).transpose(1, 2).to(torch.bfloat16)

    return ungroup(dq, h), ungroup(scale * dk, hkv), ungroup(dv, hkv)


def inputs(s, h, hkv, d, seed, d_v=None):
    """bf16 q, k [B = 2, S, heads, D], v, dO [.., D_v (default D)] from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    d_v = d if d_v is None else d_v
    return tuple(torch.from_numpy(rng.normal(size=(2, s, n, w)).astype(np.float32))
                 .to(torch.bfloat16) for n, w in ((h, d), (hkv, d), (hkv, d_v), (h, d_v)))


def forward_share(q, k, v, window, split, causal=True):
    """The largest share of B7's bars any element uses: out within one bf16
    ulp, 2^-7·|ref| + 2^-7·1e-2; lse within 1e-5·max|lse|."""
    out, lse = forward(q, k, v, causal=causal, window=window, split=split)
    ref, ref_lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    d = (out.double() - ref.double()).abs()
    share = float((d / (2.0**-7 * ref.double().abs() + 2.0**-7 * 1e-2)).max())
    share_lse = float((lse - ref_lse).abs().max() / (1e-5 * ref_lse.abs().max()))
    return share, share_lse


def backward_share(q, k, v, do, window, split, causal=True):
    """The largest share of B8's bf16 bar any element of dq, dk, dv uses:
    2^-7·|ref| + 2e-5·(the element's term magnitude)."""
    out, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    got = backward(q, k, v, out, lse, do, causal=causal, window=window, split=split)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
    mags = flash_attention_bwd_magnitudes(q, k, v, out, lse, do, causal=causal, window=window)
    return max(float(((g.double() - w.double()).abs()
                      / (2.0**-7 * w.double().abs() + 2e-5 * m.double())).max())
               for g, w, m in zip(got, want, mags))


# ---- the float32 route: 3xTF32 ----

BQ_TF32X3 = 32   # query rows per tile of the dk/dv kernel


def tf32x3_bk(d: int, backward: bool = False) -> int:
    """Keys per tile of the float32 forward (``FwdTile``) or dq kernel
    (``DqTile``) at q/k head size d."""
    return (64 if d <= 32 else 32) if backward else (64 if d <= 64 else 32)


def _mm3(a, b, acc=None, split3=True):
    import test_torch_tf32x3 as t3

    return t3.mm(a, b, acc, split3=split3)


def tf32x3_fresh_pv(d: int) -> bool:
    """Whether the float32 forward takes each tile's P·V into a fresh
    accumulator added to O in float32 (``FwdTile::kFresh``), at q/k head
    size d, or accumulates into O itself."""
    return d <= 128


def _fresh_sum(acc, a, b, split3):
    """acc + a @ b with the product in a fresh wgmma accumulator, added to
    ``acc`` by one float32 addition (rounded to nearest)."""
    return acc + _mm3(a, b, split3=split3)


def forward_tf32x3(q, k, v, *, causal=True, window=None, q_offset=0, split3=True):
    """The float32 forward kernel's (out [B, Sq, H, D_v], lse [B, H, Sq]) for
    float32 q [B, Sq, H, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, D_v]: per key
    tile S = Q·Kᵀ in a fresh accumulator, scaled and masked in float32, the
    online softmax, then O·corr + P·V: into O's accumulator, or, where the
    kernel does (``tf32x3_fresh_pv``), into a fresh one added in float32."""
    b, sq, h, d = q.shape
    sk, hkv, scale = k.shape[1], k.shape[2], d**-0.5
    qg, kg, vg = _heads(q, hkv), _heads(k, hkv), _heads(v, hkv)
    ok = attention_mask(sq, causal, window, q.device, s_k=sk, q_offset=q_offset)
    m = torch.full(qg.shape[:-1], NEG_INF)
    l = torch.zeros(qg.shape[:-1])
    o = torch.zeros((*qg.shape[:-1], v.shape[-1]))
    bk = tf32x3_bk(d)
    for k0 in range(0, sk, bk):
        kt, vt = kg[..., k0:k0 + bk, :], vg[..., k0:k0 + bk, :]
        keep = ok[:, k0:k0 + bk]
        x = (_mm3(qg, kt.transpose(-1, -2), split3=split3) * scale).masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None]).masked_fill(~keep, 0.0)
        l = l * corr + p.sum(-1)
        o = (_fresh_sum(o * corr[..., None], p, vt, split3) if tf32x3_fresh_pv(d)
             else _mm3(p, vt, o * corr[..., None], split3=split3))
        m = m_new
    lf = l.clamp_min(1e-30)
    out = (o / lf[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])
    return out, (m + torch.log(lf)).reshape(b, h, sq)


def backward_tf32x3(q, k, v, out, lse, do, *, causal=True, window=None, q_offset=0,
                    split3=True):
    """The float32 backward kernels' (dq, dk, dv): dq per key tile (S, dP,
    then dS·K added to a fresh accumulator and summed in float32), dk and dv
    per 32-row query tile of each query head of the group in turn (Sᵀ, dPᵀ,
    then Pᵀ·dO and dSᵀ·Q likewise)."""
    b, sq, h, d = q.shape
    sk, hkv, scale = k.shape[1], k.shape[2], d**-0.5
    g = h // hkv
    qg, kg, vg, dog = _heads(q, hkv), _heads(k, hkv), _heads(v, hkv), _heads(do, hkv)
    ok = attention_mask(sq, causal, window, q.device, s_k=sk, q_offset=q_offset)
    lse_g = lse.float().reshape(b, hkv, g, sq)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(lse_g.shape)
    bk = tf32x3_bk(d, backward=True)
    dq = torch.zeros(qg.shape)
    for k0 in range(0, sk, bk):
        kt, vt = kg[..., k0:k0 + bk, :], vg[..., k0:k0 + bk, :]
        sc = _mm3(qg, kt.transpose(-1, -2), split3=split3)
        dp = _mm3(dog, vt.transpose(-1, -2), split3=split3)
        p = torch.exp(sc * scale - lse_g[..., None]).masked_fill(~ok[:, k0:k0 + bk], 0.0)
        dq = _fresh_sum(dq, p * (dp - dvec[..., None]), kt, split3)
    kf, vf = kg[:, :, 0], vg[:, :, 0]
    dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for gi in range(g):
        for q0 in range(0, sq, BQ_TF32X3):
            rows = slice(q0, q0 + BQ_TF32X3)
            qt, dot = qg[:, :, gi, rows], dog[:, :, gi, rows]
            st = _mm3(kf, qt.transpose(-1, -2), split3=split3)
            dpt = _mm3(vf, dot.transpose(-1, -2), split3=split3)
            pt = torch.exp(st * scale - lse_g[:, :, gi, None, rows]).masked_fill(
                ~ok[rows].T, 0.0)
            dv = _fresh_sum(dv, pt, dot, split3)
            dk = _fresh_sum(dk, pt * (dpt - dvec[:, :, gi, None, rows]), qt, split3)

    def ungroup(x, n):
        return x.reshape(b, n, -1, x.shape[-1]).transpose(1, 2)

    return ungroup(scale * dq, h), ungroup(scale * dk, hkv), ungroup(dv, hkv)


def inputs_f32(sq, h, hkv, d, seed, d_v=None, sk=None):
    """float32 q, dO [B = 2, Sq, H, D / D_v] and k, v [2, Sk, Hkv, D / D_v]
    from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    d_v, sk = d if d_v is None else d_v, sq if sk is None else sk
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, s, n, w)).astype(np.float32))
                   for s, n, w in ((sq, h, d), (sk, hkv, d), (sk, hkv, d_v), (sq, h, d_v)))
    return q, k, v, do


def tf32x3_shares(q, k, v, do, *, causal=True, window=None, q_offset=0, split3=True):
    """The largest share of chip_smoke.py's float32 bars each output uses:
    (B7 out, within 1e-5·max(1, max|ref|); lse, 1e-5·max|lse|; B8, each
    element of dq, dk and dv within 1e-5 of its term magnitude)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = forward_tf32x3(q, k, v, split3=split3, **kw)
    ref, ref_lse = flash_attention_ref(q, k, v, **kw)
    share_out = float((out.double() - ref.double()).abs().max()
                      / (1e-5 * max(1.0, float(ref.abs().max()))))
    share_lse = float((lse.double() - ref_lse.double()).abs().max()
                      / (1e-5 * float(ref_lse.abs().max())))
    got = backward_tf32x3(q, k, v, ref, ref_lse, do, split3=split3, **kw)
    want = flash_attention_bwd_ref(q, k, v, ref, ref_lse, do, **kw)
    mags = flash_attention_bwd_magnitudes(q, k, v, ref, ref_lse, do, **kw)
    share_bwd = max(float(((x.double() - w.double()).abs() / (1e-5 * m.double())).max())
                    for x, w, m in zip(got, want, mags))
    return share_out, share_lse, share_bwd


if __name__ == "__main__":
    for s, h, hkv, d, window in CASES:
        q, k, v, do = inputs(s, h, hkv, d, seed=s + d)
        fwd = {split: forward_share(q, k, v, window, split) for split in (True, False)}
        bwd = {split: backward_share(q, k, v, do, window, split) for split in (True, False)}
        print(f"S={s} H={h}/{hkv} D={d} window={window}: forward out/lse share of the bar "
              f"hi+lo {fwd[True][0]:.3f}/{fwd[True][1]:.3f}, single {fwd[False][0]:.3f}/"
              f"{fwd[False][1]:.3f}; backward hi+lo {bwd[True]:.3f}, single {bwd[False]:.3f}")
    for s, h, hkv, d, d_v, causal in NEW_CASES:
        q, k, v, do = inputs(s, h, hkv, d, seed=s + d, d_v=d_v)
        fwd = forward_share(q, k, v, None, True, causal)
        bwd = backward_share(q, k, v, do, None, True, causal)
        print(f"S={s} H={h}/{hkv} ({d}, {d_v}) causal={causal}: forward out/lse share hi+lo "
              f"{fwd[0]:.3f}/{fwd[1]:.3f}; backward hi+lo {bwd:.3f}")
