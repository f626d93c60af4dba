"""Pluggable backend for the per-output Gram sufficient statistics.

Counterpart of ``repro/core/stats_backend.py``.  DAEF's training cost is
dominated by the per-layer statistics

    G[o] = Xa · diag(f'²[o]) · Xaᵀ        [o, m, m]
    M[o] = Xa · (f'²[o] ∘ d̄[o])           [o, m]

which :func:`gram_stats` computes with one of two backends:

* ``"einsum"`` — two plain torch einsums in the input dtype;
* ``"fused"``  — the hand-written ``rolann_stats`` CUDA kernel
  (``kernels/rolann_stats``); for CPU tensors its wrapper runs the plain
  version with the kernel's float32 contract.
* ``"auto"``   — resolves to ``"einsum"``: no H100 measurement has chosen a
  winner yet (the reference's ``_resolve_auto`` does the same for platforms
  its autotune cache has not measured).  It never reaches a kernel.

Selection precedence: explicit ``backend=`` (or a non-None
``DAEFConfig.stats_backend``) > ``$REPRO_STATS_BACKEND`` > ``"auto"``.

The batched, accumulating and fused-chunk entry points wait for the fleet
and streaming slices (ROADMAP queue A items 7-8).
"""
from __future__ import annotations

import os

import torch

#: Concrete backends a call can dispatch to; ``AUTO`` is collapsed first.
BACKENDS = ("einsum", "fused")
AUTO = "auto"
ENV_VAR = "REPRO_STATS_BACKEND"
DEFAULT = AUTO


def _resolve_auto() -> str:
    return "einsum"


def resolve(backend: str | None = None) -> str:
    """Concrete backend name: explicit arg > $REPRO_STATS_BACKEND > "auto"."""
    if backend is None:
        backend = os.environ.get(ENV_VAR) or DEFAULT
    if backend == AUTO:
        return _resolve_auto()
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown stats backend {backend!r}: choose from "
            f"{(*BACKENDS, AUTO)} (explicitly or via ${ENV_VAR})"
        )
    return backend


def gram_stats(
    xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor, *,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, M) per-output statistics for xa [m, n], fsq/fd [o, n]."""
    if resolve(backend) == "fused":
        from repro_torch.kernels.rolann_stats import rolann_stats

        return rolann_stats(xa, fsq, fd)
    g = torch.einsum("in,on,jn->oij", xa, fsq, xa)
    m = torch.einsum("in,on->oi", xa, fd)
    return g, m


__all__ = ["AUTO", "BACKENDS", "DEFAULT", "ENV_VAR", "gram_stats", "resolve"]
