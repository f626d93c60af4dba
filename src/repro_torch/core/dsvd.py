"""Distributed truncated SVD (DSVD) — the DAEF encoder (paper §4.1).

Counterpart of ``repro/core/dsvd.py``, gram route only.  The encoder weights
are the first ``m1`` left singular vectors of the data ``X [m0, n]``.  Over
partitions ``X = [X^1 | ... | X^P]``, ``U S^2 U^T = sum_p X^p X^p^T``, so the
sum of the partition Grams followed by one ``eigh`` gives the merged factors.

:func:`masked_gram` is the streaming fit's per-chunk Gram.  The
paper-faithful ``method="svd"`` route (local SVDs, concatenation, merge
SVD), ``merge_factors`` and ``pad_rank`` wait for ROADMAP queue A item 3.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class SvdFactors(NamedTuple):
    """Truncated left factorization: u [m, r], s [r]."""

    u: torch.Tensor
    s: torch.Tensor


def canonicalize_signs(u: torch.Tensor) -> torch.Tensor:
    """Fix the SVD sign ambiguity: flip each column of U so its
    largest-magnitude entry is positive (the first one on ties)."""
    idx = torch.argmax(torch.abs(u), dim=0)
    signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return u * signs[None, :]


def gram(x: torch.Tensor) -> torch.Tensor:
    """Local Gram matrix X^p X^p^T — the additive sufficient statistic."""
    return x @ x.T


def masked_gram(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Gram contribution of one sample chunk; ``mask`` ([n] in {0, 1}) zeroes
    padded columns exactly, so streamed fits can pad ragged chunks to a fixed
    shape.  Summed over chunks it equals :func:`gram` of the concatenation."""
    if mask is None:
        return x @ x.T
    return (x * mask.to(x.dtype)[None, :]) @ x.T


def gram_to_factors(g: torch.Tensor) -> SvdFactors:
    """eigh of the summed Gram == the merged SVD factors.

    ``torch.linalg.eigh`` returns ascending eigenvalues; reverse them to the
    SVD's descending order, as the reference does.
    """
    evals, evecs = torch.linalg.eigh(g)
    evals = torch.clamp(evals, min=0.0)
    return SvdFactors(
        u=canonicalize_signs(torch.flip(evecs, dims=(1,))),
        s=torch.sqrt(torch.flip(evals, dims=(0,))),
    )


def truncate(f: SvdFactors, rank: int) -> SvdFactors:
    return SvdFactors(u=f.u[:, :rank], s=f.s[:rank])


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
