"""Distributed truncated SVD (DSVD) — the DAEF encoder (paper §4.1).

Counterpart of ``repro/core/dsvd.py``.  The encoder weights are the first
``m1`` left singular vectors of the data ``X [m0, n]``.  Over partitions
``X = [X^1 | ... | X^P]``, :func:`dsvd` takes either route of the
reference: ``"svd"`` (the paper's: local SVDs, merged by Eq. 2) or
``"gram"`` (``U S^2 U^T = sum_p X^p X^p^T``, so the sum of the partition
Grams followed by one ``eigh`` gives the merged factors).

:func:`masked_gram` is the streaming fit's per-chunk Gram.  The merges of
the paper's Eq. 2 (:func:`local_svd`, :func:`merge_factors`,
:func:`merge_pair`, :func:`pad_rank`) combine two models' encoders, gram
method included.  The DAEF fits pass their config's method: "gram" for
the gram method, "svd" (local SVDs merged by Eq. 2) for the svd method.

Factors may carry leading batch axes (a tenant fleet's [K]): u [..., m, r],
s [..., r].  Every function here works on the trailing axes.

The SVDs keep only U and S (:func:`left_svd`): the SVD of the small R of
a QR of the tall transpose, so the right factors of an [m, n] matrix are
never formed.  On the card that R comes from a tree of QRs of row blocks
(TSQR): PyTorch factors a batch of tall matrices there one by one, and a
batch of short ones in one call.  On the host LAPACK's blocked QR of the
whole matrix is faster than a batch of small ones.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F


# Rows of each block of the tree of QRs on the card: a batch of QRs of at
# most 256 rows is one batched call there.
QR_BLOCK_ROWS = 256


def _tall_r(t: torch.Tensor, rows: int | None) -> torch.Tensor:
    """R [..., min(n, m), m] of the reduced QR of t [..., n, m].  With
    ``rows``, while the matrices are taller than ``rows`` and their blocks'
    stacked R's are shorter than they are, their row blocks are factored in
    one batch and the stacked R's factored again.  ``[A_1; A_2] =
    diag(Q_1, Q_2) [R_1; R_2]`` makes R of the stack an R of the whole,
    TSQR is backward stable as Householder QR is, and zero rows padding the
    last block change no R."""
    n, m = t.shape[-2:]
    while rows is not None and n > rows:
        blocks = -(-n // rows)
        if blocks * m >= n:
            break
        t = F.pad(t, (0, 0, 0, blocks * rows - n))
        r = torch.linalg.qr(t.reshape(*t.shape[:-2], blocks, rows, m), mode="r").R
        t = r.reshape(*r.shape[:-3], blocks * m, m)
        n = blocks * m
    return torch.linalg.qr(t, mode="r").R


def left_svd(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """U [..., m, r] and S [..., r] of the SVD of ``a`` [..., m, n], r =
    min(m, n), S descending.  With ``a``ᵀ = Q R (reduced, R [..., r, m]),
    ``a = Rᵀ Qᵀ`` and Q has orthonormal columns, so ``a`` has the left
    factors and singular values of Rᵀ [..., m, r]; R by the tree of QRs on
    the card, by one QR on the host."""
    r = _tall_r(a.transpose(-1, -2), QR_BLOCK_ROWS if a.is_cuda else None)
    u, s, _ = torch.linalg.svd(r.transpose(-1, -2), full_matrices=False)
    return u, s


class SvdFactors(NamedTuple):
    """Truncated left factorization: u [m, r], s [r]."""

    u: torch.Tensor
    s: torch.Tensor


def canonicalize_signs(u: torch.Tensor) -> torch.Tensor:
    """Fix the SVD sign ambiguity: flip each column of U [..., m, r] so its
    largest-magnitude entry is positive (the first one on ties)."""
    idx = torch.argmax(torch.abs(u), dim=-2, keepdim=True)      # [..., 1, r]
    signs = torch.sign(torch.gather(u, -2, idx))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return u * signs


def local_svd(x: torch.Tensor, rank: int | None = None) -> SvdFactors:
    """Local SVD of one partition x [..., m, n_p]; keep at most ``rank``
    factors.  For the merge to be exact, locals keep full rank (the
    default) and the merged factors are truncated at the end."""
    u, s = left_svd(x)
    if rank is not None:
        u, s = u[..., :rank], s[..., :rank]
    return SvdFactors(u=canonicalize_signs(u), s=s)


def merge_factors(parts: Sequence[SvdFactors]) -> SvdFactors:
    """The paper's Eq. 2: SVD of the concatenated U^p S^p blocks, keeping
    at most m factors."""
    cat = torch.cat([p.u * p.s[..., None, :] for p in parts], dim=-1)
    u, s = left_svd(cat)
    m = cat.shape[-2]
    return SvdFactors(u=canonicalize_signs(u[..., :m]), s=s[..., :m])


def merge_pair(a: SvdFactors, b: SvdFactors) -> SvdFactors:
    """Incremental two-way merge (a new data block arriving at a node)."""
    return merge_factors([a, b])


def gram(x: torch.Tensor) -> torch.Tensor:
    """Local Gram matrix X^p X^p^T — the additive sufficient statistic."""
    return x @ x.transpose(-1, -2)


def masked_gram(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Gram contribution of one sample chunk x [..., m, n]; ``mask`` ([n] in
    {0, 1}) zeroes padded columns exactly, so streamed fits can pad ragged
    chunks to a fixed shape.  Summed over chunks it equals :func:`gram` of
    the concatenation."""
    if mask is None:
        return x @ x.transpose(-1, -2)
    return (x * mask.to(x.dtype)) @ x.transpose(-1, -2)


def gram_to_factors(g: torch.Tensor) -> SvdFactors:
    """eigh of the summed Gram [..., m, m] == the merged SVD factors.

    ``torch.linalg.eigh`` returns ascending eigenvalues; reverse them to the
    SVD's descending order, as the reference does.
    """
    evals, evecs = torch.linalg.eigh(g)
    evals = torch.clamp(evals, min=0.0)
    return SvdFactors(
        u=canonicalize_signs(torch.flip(evecs, dims=(-1,))),
        s=torch.sqrt(torch.flip(evals, dims=(-1,))),
    )


def truncate(f: SvdFactors, rank: int) -> SvdFactors:
    return SvdFactors(u=f.u[..., :rank], s=f.s[..., :rank])


def pad_rank(f: SvdFactors, rank: int) -> SvdFactors:
    """Zero-pad (u, s) with trailing zero factors up to ``rank``.

    Exact under both merge algebras: zero singular values add nothing to
    the concatenated SVD (Eq. 2) and leave ``U S^2 U^T`` unchanged, so
    ragged local factorizations (r = min(m, n_p)) stack into one shape.
    """
    r = f.s.shape[-1]
    if r > rank:
        raise ValueError(
            f"cannot pad rank {r} down to {rank} — use dsvd.truncate"
        )
    if r == rank:
        return f
    return SvdFactors(u=F.pad(f.u, (0, rank - r)), s=F.pad(f.s, (0, rank - r)))


def dsvd(
    partitions: Sequence[torch.Tensor], rank: int, *, method: str = "svd"
) -> SvdFactors:
    """Distributed SVD over explicit partitions (single-host simulation).

    method: "svd" — paper-faithful (local SVDs, concat, merge SVD);
            "gram" — sum of partition Grams + one eigh (the same factors).
    """
    if method == "svd":
        merged = merge_factors([local_svd(p) for p in partitions])
    elif method == "gram":
        merged = gram_to_factors(sum(gram(p) for p in partitions))
    else:
        raise ValueError(f"unknown DSVD method {method!r}")
    return truncate(merged, rank)
