"""Distributed truncated SVD (DSVD) — the DAEF encoder (paper §4.1).

Counterpart of ``repro/core/dsvd.py``, gram route only.  The encoder weights
are the first ``m1`` left singular vectors of the data ``X [m0, n]``.  Over
partitions ``X = [X^1 | ... | X^P]``, ``U S^2 U^T = sum_p X^p X^p^T``, so the
sum of the partition Grams followed by one ``eigh`` gives the merged factors.

:func:`masked_gram` is the streaming fit's per-chunk Gram.  The merges of
the paper's Eq. 2 (:func:`local_svd`, :func:`merge_factors`,
:func:`merge_pair`, :func:`pad_rank`) combine two models' encoders, gram
method included.  The ``method="svd"`` fit route waits for ROADMAP queue A
item 3.

Factors may carry leading batch axes (a tenant fleet's [K]): u [..., m, r],
s [..., r].  Every function here works on the trailing axes.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F


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
    u, s, _ = torch.linalg.svd(x, full_matrices=False)
    if rank is not None:
        u, s = u[..., :rank], s[..., :rank]
    return SvdFactors(u=canonicalize_signs(u), s=s)


def merge_factors(parts: Sequence[SvdFactors]) -> SvdFactors:
    """The paper's Eq. 2: SVD of the concatenated U^p S^p blocks, keeping
    at most m factors."""
    cat = torch.cat([p.u * p.s[..., None, :] for p in parts], dim=-1)
    u, s, _ = torch.linalg.svd(cat, full_matrices=False)
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
    partitions: Sequence[torch.Tensor], rank: int, *, method: str = "gram"
) -> SvdFactors:
    """Distributed SVD over explicit partitions (single-host simulation).

    method: "gram" — sum of partition Grams + one eigh.  The reference's
    "svd" route is not ported yet and raises.
    """
    if method == "svd":
        raise NotImplementedError(
            "dsvd(method='svd') is not ported yet (ROADMAP queue A item 3); "
            "use method='gram', which gives the same factors"
        )
    if method != "gram":
        raise ValueError(f"unknown DSVD method {method!r}")
    g = sum(gram(p) for p in partitions)
    return truncate(gram_to_factors(g), rank)
